"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases build,train_kernels   # a short check

Drives the port's paths at the flagship width — eval/predict (the
JAX package's eval command, ref main.py:32-37 -> evaluate.py:121
`evaluate`), training (ref main.py:25-27 -> train.py:1698 `train`,
the flagship `--train-flag --batch-size 16 --amp --num-stack 1`, with
the fused loss of ref train.py:274-278) and a gradient through the
eval-mode model (`jax.grad` of `model.apply(train=False)`) — then the
same paths for the JAX model's other architectures and NMS modes
(VARIANT_CONFIGS: the edge and quality tiers' architectures, ref
config.py:59-85, the depthwise variant, the other options), and checks
every hand-written kernel of those paths against its plain PyTorch
version on the card:

1. card identity (torch + nvidia-smi);
2. build the kernels from csrc/ (one nvcc per source, in parallel) and
   print nvcc's `-Xptxas -v` register / shared-memory / spill report;
3. each eval kernel against its plain version at the main path's shapes,
   f32 and bf16, every activation, pool sizes 3 and 5 — bit-equal for
   the peak test and the ReLU/Linear epilogue and residual tail; Mish
   within rtol 1e-6 (f32) or one bf16 ulp (bf16); the epilogue also at
   ragged element counts, at a channel count and on a misaligned view
   that take its scalar kernel, each site on the variant it should take;
   the peak test also with NaN and +-inf logits (NaN-aware), at ragged
   tiles and a pool of 81 on its vector variant, and at w % 4 != 0,
   three classes and misaligned logits on its scalar one;
4. eval kernel time (CUDA graph replay, CUDA events) beside the least
   time the card could take (bytes / 3.35 TB/s; for the peak test also
   the bytes the logits' layout forces), the plain version's time and
   the time of a one-call PyTorch equivalent where one exists; the
   epilogue's vector and scalar kernels at every EPI_SHAPES site, ReLU,
   f32 and bf16, in turns (vector, scalar, scalar, vector); the peak
   test's scalar variant beside its vector one;
5. the predict path, batch 16, 512^2, 1 stack, 128 channels, seeded
   weights, f32 and bf16: launch counts per forward (20 epilogue, all on
   the vector kernel, 17 residual tail, 1 peak, no train kernel;
   `expected_launches`), logits of the whole batch bit-equal and
   Detections identical, and matched both ways, against the same path
   with every kernel swapped for its plain version, peak memory, images/s as the median of 3 windows
   of about 1 s each (kernel and plain windows alternate), and a small
   model on the card against the CPU path;
6. the same kernel-vs-plain rule under two BN states with larger
   logits, where scores round to 1 and ties decide the order;
7. train_kernels: the train kernels (batch moments, backward sums, dx,
   with and without the skip) against their plain versions at every BN
   site shape of the train step, f32 and bf16, every activation — dx
   bit-equal for ReLU/Linear (Mish as in 3), the reductions within 1e-5
   of the sum of |terms| per channel;
8. train_timing: train kernel time at the largest site beside its bound,
   the plain version and `torch.var_mean` / ATen's BN backward;
9. loss_kernels: the fused loss's two kernels against their plain
   versions at the flagship's (16, 1, 128, 128, 6) output on
   synthetic_target_batch, f32 and bf16 logits, `normalized` both ways,
   alpha/beta 3/3, no positives, logits x20 (saturated sigmoids), a
   mask of fractions and zeros, NaN and +-inf logits: each (stack,
   sample) sum within 1e-5 of the plain version's sum of |terms| (NaN
   where it is NaN), d(out) bit-equal (NaN-aware); the backward also at
   two stacks with a ragged tile (vector kernel), at H*W % 4 != 0 and on
   misaligned storage (scalar kernel), each on the kernel it should
   take;
10. loss_timing: the two loss kernels beside their bounds, the plain
   versions and the eager composition's forward + backward, the
   backward's scalar kernel beside its vector one; each kernel's own
   device time and device operations per call from a torch.profiler
   trace (one each, nothing besides the kernel);
11. train_main: the flagship --amp train step at b16 512^2 on the port's
   synthetic_target_batch: launch counts per step (37 moments, 20 + 17
   backward sums and dx, 20 epilogue, 17 tail, the loss kernels once
   each), one step's loss, gradients and running statistics against the
   plain-version step (cudnn.deterministic) and, in f32, both against
   the step with float64 BN sums, the loss over 20 steps on one batch,
   images/s over alternating ~1 s windows, peak memory; the training-log
   snapshot of the trained model (`train.make_snapshot_fn`: #2 20 and #8
   17 launches, the heatmap bit-equal to the plain eval forward, the
   model back in train mode with its BN buffers and the RNG states
   untouched) and the wall of a print step's two PNGs; then one f32
   step;
11b. accum: gradient accumulation at the flagship's width, b16 512^2
   --amp: one `--grad-accum 2` step through the kernels against the
   plain versions (train_main's bf16 rule) and its launches, twice one
   step's derived counts; three `--sub-divisions 2` host steps of an
   epoch of 3 through `train_epoch` (no update, an update, the epoch-end
   flush); one `--grad-accum 2` step against two `--sub-divisions 2`
   steps on its halves (SGD, f32, parameters rel L2 1e-5); train images/s
   and peak memory of grad-accum 1 and 2 in alternating windows;
11c. ddp: DistributedDataParallel on the one card: world 1 over NCCL,
   the flagship --amp step bit-equal to the unwrapped step and launching
   one step's counts; world 2 over gloo (two processes of this script,
   `--ddp-worker`, both on cuda:0, 8 images each, f32) against the
   single-process 16-image step (loss rel 1e-5, the update rel L2 5e-3,
   running statistics bit-equal across the ranks and rel L2 1e-5, the
   launches of one step at b8 per rank); the eval CLI at world 2 against
   one process on 32 images (the same mAP, rank 0's detections, the txt
   files and the pickle from rank 0 alone);
11d. train_extras: the train-step extras at b16 512^2: `--fwd-dtype
   int8` (the flagship --amp step with the abs-max, #16 and #14 at its 35
   STE sites, all on wgmma, against the plain versions by train_main's
   bf16 rule;
   the edge architecture's step with #15; launches as `ste_walk`
   derives; img/s and peak memory against --fwd-dtype bf16),
   `--param-policy bf16-compute` (bf16 parameters of f32 masters, no
   per-call weight cast, one SGD step's loss rel 1e-3 and update rel L2
   2e-2 against the fp32 policy, img/s and peak memory against it),
   `--remat stacks|full` (f32, cudnn.deterministic: loss, gradients and
   running statistics bit-equal to none, launches with the recompute,
   peak memory and ms a step at --amp), the EMA (3 steps equal to the
   host recurrence; a checkpoint through the eval CLI with --ema-eval
   to the EMA npz's detections), `--sentinel` (a NaN batch keeps every
   state tensor bit-identical with no host sync more than the plain
   step's, a finite spike is skipped, the backoff ladder), `--distill`
   (a 2-stack flagship teacher the phase writes, an edge-architecture
   student: the teacher's #2/#8 launches, the loss falls over 8 steps),
   `--sentinel --sub-divisions 2` (4 micro-steps with the 2nd poisoned:
   in f32 under cudnn.deterministic every state tensor, the device
   window among them, bit-equal to the same run with that micro-batch
   left out; at --amp the skip, launches 4 steps' worth, host syncs no
   more than the plain `--sub-divisions 2` step's), `--tier throughput
   --train-flag` (3 steps of the tier's float ghost-96 architecture at
   --amp, launches as derived, finite loss; its checkpoint evaluated at
   the tier: #14-#16 and #1 launched as the int8 predict derives, the
   detections equal to a twin built from the same npz);
11e. train_runtime: the training runtime at the flagship's width, b16
   512^2 --amp, max_boxes 128, on a 160-image 512^2 fixture: the device
   augmentation and encoder (`--device-augment`) on the card against the
   CPU on one draw (boxes, validity and mask identical, the image within
   one grey level, the maps 1e-6); the `--device-augment` and
   `--cache-device` steps launching one step's derived counts, an f32
   device-augmented step against the plain kernels by train_main's rule,
   20 cached steps whose loss falls; `--telemetry`'s norms against the
   state (rel 1e-5) and its host syncs a step against the plain step's;
   images/s and data wait a step of the thread loader, `--loader
   process`, `--device-prefetch 2`, `--device-augment` and
   `--cache-device` (an epoch of 10 steps after a warm-up epoch), the H2D
   bytes a step and the cache's bytes an image; an `--async-ckpt`
   checkpoint bit-equal to a sync one and the loop's stall at the
   boundary of each; `--keep-ckpt 1 --ckpt-interval 2` leaving its one
   dir; `--fault-inject 1:1 --auto-resume 1` (with `--loader process
   --device-prefetch 2 --span-log`) against a clean run under
   cudnn.deterministic (bit-equal, or within train_main's f32 gradient
   rule, which the log says) and the span log's JAX names;
   `--async-eval`'s subprocess mAP against `evaluate` within 1e-3 and
   the train images/s beside it; `--prewarm` leaving the state
   bit-identical, each bucket's first step cold and after it; a NaN
   batch dropped and counted by the process loader's quarantine;
12. eval_grad: the eval-mode BN backward kernels against their plain
   versions at every BN site shape, f32 and bf16, every activation (dx
   and ds bit-equal for ReLU/Linear, Mish as in 3, partials within 1e-5
   of the sum of |terms|); then the flagship model in eval mode at b16
   512^2, the fused loss and backward(), f32 and bf16, through the
   kernels and through the plain versions: launch counts (20 + 17 eval
   backward, the loss kernels once each; `expected_launches`), a
   non-zero gradient for every
   parameter, f32 gradient rel L2 <= 1e-5, bf16 no further from the f32
   plain gradient than 1.5x the bf16 plain path;
13. eval_timing: the eval backward kernels at the largest site beside
   their bounds, the plain versions and ATen's BN backward (Linear);
14. variants: predict at b16 512^2, f32 and bf16, for each of
   VARIANT_CONFIGS (edge-arch: ghost, width 64, stem 64; quality-arch: 2
   stacks, soft-NMS; depthwise-128; options: PReLU, a Mish neck, the
   Conv pool, the SPP neck, the s2d stem): launch counts per forward
   against the counts derived from the architecture (`bn_sites`,
   `expected_launches`), logits bit-equal and Detections identical
   against the plain-version path (where a site takes Mish: phase main's
   rule), peak memory, images/s (three ~0.5 s windows a path), device
   busy and idle share from one profiled predict; the stem direct and
   space-to-depth, side by side; the SPP pools' cascade bit-equal to the
   direct pools;
15. variants_small: the other options (Avg and SPP pools, LReLU, Sigmoid,
   CELU, Mish, maxpool NMS) at b4 128^2, width 32, the same way;
16. variants_train: the --amp train step at b16 512^2 for edge-arch and
   depthwise-128: launch counts, the step against its plain-version twin
   under train_main's rule, the loss over 8 steps, images/s; an
   eval-mode gradient for edge-arch and options (every parameter, the
   PReLU slopes among them, non-zero);
17. nms: soft-NMS, maxpool and hard NMS, the card against the CPU (keep
   masks identical, decayed scores within 1e-6), on seeded clustered
   boxes where each mode keeps some and drops others, and on a
   quality-arch predict's decoded boxes, with the time of each per b16
   batch;
18. serve: the serving engine (the eval and demo predict path; ref
   serving/engine.py:274) at b16 512^2, the uint8 wire: the flagship f32
   and bf16 with buckets 1-16, depth 2 — one CUDA graph per bucket
   (capture time, graph nodes) and none after construction, each
   bucket's replay launches from a profiler trace against
   `expected_launches` (no train kernel), each bucket's rows bit-equal to
   the eager predict at its batch size, across buckets f32 rows matched
   both ways and bf16 logits no further apart than bf16 is from f32, a
   dispatch fault and a hung fetch retried bit-identically, a
   hot reload (storages kept, rows equal to an eager predict of the new
   weights), a saturated closed loop (64 outstanding, three ~1 s windows)
   against eager windows, the serial bucket-1 latency p50/p99, the idle
   share of a saturated window, peak memory; then `--tier edge` and
   `--tier quality` (bf16, through `apply_tier`): captures, launches, rows,
   images/s at the largest bucket and bucket-1 latency;
19. qkernels: the int8 kernels (#14 the dense 1x1/3x3 int8 conv on its
   wgmma kernel and its first, mma.sync one; #15 the depthwise one,
   tiled and gather; #16 the activation quantizer; the abs-max; no
   Pallas counterpart) against their plain versions at every int8 conv
   site of the throughput tier and the flagship at b16 512^2 (the int32
   sums and the f32/bf16 ReLU/Linear outputs bit-equal, each conv on
   each of its kernels), the convs' code outputs (the codes of the
   stored values at a consumer's step, at a channel offset of a wider
   tensor whose other channels stay, one or two of them, with or
   without the float output) on each kernel at every throughput-tier
   site, at odd shapes (ragged boxes, one image, Cout past one wgmma
   width, C % 16 != 0) and on views 16 bytes into their storage, the
   quantizer at one and two steps and the abs-max at every site input,
   on the quantizer's ties, +-inf, saturation and NaN (0, JAX-CPU's
   value; the abs-max NaN, +-inf, -0.0), and the wrappers' refusals
   (misaligned inputs and code outputs, a code offset off 8, codes of
   int32 sums, not channels-last, other geometry);
20. qtiming: their time at the throughput tier's largest sites and the
   flagship's largest 3x3 and its 3x3 at 128^2, each conv's new kernel
   and its first one in turns, beside the bound, the plain version,
   `torch._int_mm` (the library's int32 sums alone) and cuDNN's bf16
   conv (a float yardstick); the quantizer beside
   `torch.quantize_per_tensor` (its library call, on the f32 values; the
   values where the two differ counted); the fused forms (a ghost
   module's 1x1 writing two code outputs, a depthwise conv and the
   flagship's 3x3 one) in turns with the unfused conv + quantizer
   launches they replace; the quantizer at each of its sites on the
   fused predicts beside its bound; the abs-max beside `x.abs().amax()`
   and `torch.linalg.vector_norm(x, inf)`;
21. int8: `--infer-dtype int8` predicts at b16 512^2 for the throughput
   tier and the flagship, bf16 and f32: scales calibrated on the card,
   launches as derived (`qconv_sites`, by kernel: every dense conv on
   the wgmma kernel, every depthwise one on the tiled kernel; the convs
   that write their consumers' codes, `code_walk`; the quantizer 18
   times, once at two steps, `quant_walk`; the peak test once, no BN
   kernel), logits bit-equal and Detections identical to the plain
   twin, peak memory, images/s against the float model, #14's, #15's
   and #16's device sums per predict against the float model's
   convolutions, the predict's busy time, and the int8 vs float
   agreement (a record);
22. serve_int8: `--tier throughput` through the engine (buckets 4/8/16)
   with an SLO watchdog: one graph per bucket, replay launches, rows
   bit-equal to eager, a closed loop of 64 clients and open loops at 50%
   and 90% of its rate (p50/p99, alerts), a reload of weights and scales
   with no capture, and eval at the tier through the engine against
   eager int8 predicts;
22b. fleet: the serving fleet through `serving.runs` (the port of
   scripts/serve_bench.py's fleet mode): flagship bf16 replicas, buckets
   1-16, each an engine with its own model and graphs on the one card;
   closed loops of 64 at 1 and 2 replicas, rows bit-equal to the eager
   predict at the bucket that served them, skewed routing, a tenant over
   its budget, a seeded replica death with its respawn, a canary promote
   and a rollback; launches per replay against `expected_launches`;
22c. cascade: the edge tier with the confidence in its graphs in front
   of the quality tier, at the calibrated threshold: the confidence
   bit-equal to the host's, answers bit-equal to the answering tier's,
   an escalation fault and a quality replica's death; escalation rate,
   images/s, p50/p99;
22d. streams: 4 seeded 1024^2 streams of 2 x 2 tiles over an edge-tier
   engine: the card's delta summary bit-equal to the CPU's, tile gating,
   the stitched answer against each tile's predict, in-order delivery,
   frame and tile faults; frames/s gated and ungated at one offered rate;
22e. serve_bench: `serving.runs` engine mode at the flagship's full
   width under injected faults (the serial bucket-1 server against the
   engine's load curve, rows bit-equal to the eager predict, lost 0, a
   retry, launches per replay, complete traces), the simulated fleet,
   cascade and streams sections (escalations against the host oracle,
   lost 0) and the selfcheck on the card;
23. export: `export_predict` (the port of ref export.py:60) at 512^2,
   the uint8 wire: the flagship bf16 with --export-serve at buckets 1
   and 16, and `--tier throughput` int8, each with one AOTInductor
   package (batch 1), each exported by a worker process that phase
   export_compile starts right after the build: every reloaded `.pt2` bit-equal to the eager
   predict at its batch, its launches by kernel name (profiler) and by
   the counters equal to `expected_launches`; the op library
   (csrc/torch_ops.cpp) and the C++ runner (cpp/runner.cc) built with
   g++, the runner run with no Python on each package with a seeded
   uint8 image file: detections matched both ways against the Python
   program's, per-frame op calls equal to the derived launches, latency
   p50/p99 at depth 1 and frames/s at depths 1 and 4 beside the serving
   engine's bucket-1 latency; export wall, program sizes, compile
   seconds; the host microseconds of one call of each `helmet` op
   against the route before the ops;
25. the eval CLI end to end (through the serving engine) on a synthetic
   VOC fixture (32 images at 512^2, batch 16, --amp) to a printed mAP,
   txt files and pickle, the mAP within 1e-3 of eager predicts' over the
   same fixture;
26. train_cli: `--train-flag` for one epoch on a 32-image 512^2 fixture
   (its training_log/ gt and pred PNGs of both steps), then the eval CLI
   on the weights it wrote; one epoch with `--device-augment
   --cache-device --prewarm`; then one epoch with `--grad-accum 2
   --sub-divisions 2 --profile` on 128 images (8 steps, 4 updates),
   whose loss must fall and whose `<save>/trace/trace.json` holds the
   train kernels #4-#13 and exactly the ProfilerStep markers of steps
   2-7; the layer table each run prints (`--summary`) totals the model's
   parameters, and the table's function, called under torch.profiler
   with the model on the card, launches nothing and copies nothing;
27. supervisor: the job supervisor (`runtime/supervisor.py`) with its
   default probes over real subprocess jobs on a 32-image 512^2
   fixture: the triage (one waiter, #1 launched once and bit-equal to
   its plain version); the flagship `--amp` train CLI as a job, hung on
   its first attempt by a SIGSTOP of its process group after its first
   checkpoint, stale-killed past a 30 s heartbeat deadline, salvaged
   with its `check_point_*`, requeued and resumed from its save dir by
   the same command to its last step, its group gone; the eval of that
   save dir, whose txt files score to its own mAP (1e-9); a
   `run_as_job` job failing transiently once, then done; a bad flag
   failing once; traceview over the jobs' span log (0 orphans, 0 broken
   chains); the queue metrics; the walls of each attempt, the kill, the
   respawn to the first step and the triage;
28. analysis: the transfer audit on the card: predict, serve b1/b2/b4
   and the train step at the audit's tiny shapes
   (`analysis.transfer_audit`), each run once under torch.profiler
   after a warm-up, its `Memcpy HtoD`/`DtoH` records against
   `analysis/transfer_manifest.json` (counts exact, bytes within 2%);
   then the flagship bf16 b16 512^2 predict and the served bucket 16,
   their copies' counts equal to the tiny entries';
29. quality: the quality matrix (`quality.matrix`, the port of
   scripts/quality_matrix.py) on the card: `--tiers`, `--cascade` and
   `--streams` at `--smoke` sizes (64^2, the blocks fixture) at the
   tiers' real widths (`--width-scale 1`: a width / 4 throughput tier
   has channel counts the int8 kernels refuse), `--epochs 2 --train 16
   --test 8` (`--streams` on 4 videos of 4 frames), in a temp dir: four
   trainings through `train.train`
   (quality, edge from scratch, edge and throughput distilled), the
   tiers' evals (the throughput tier's also through int8), the counting
   model and served b1 latency of each tier, the cascade and stream
   sweeps; every kernel of those paths launched (the counters); one eval
   predict of each tier counted by kernel name in a profiler trace
   (`program_launches`: retaken when short of the counters' launches)
   against `want_replay` (#1, #2, #8; #16/#14/#15 for the throughput
   tier's int8 predict); the cascade's escalation rate never falling as
   the threshold rises, its ends the all-edge and all-quality mAPs; the
   stream sweep at threshold 0 equal to full inference; no record
   written to the package's calibration/; the `_source` of both served
   thresholds printed;
30. report: the round report (`obs.report`, the port of
   scripts/obs_report.py) over the span logs, journal and metrics that
   the supervisor, streams and quality phases of this run wrote (over
   the quality phase's span log alone when the others did not run): 0
   orphan traces, 0 broken chains, the streams' fault run's frames and
   gaps, the jobs' final states;
31. roofline, last (no profiler session follows it): where the card's
   time goes (`obs.roofline`, `obs.breakdown`, `obs.trace_summary`):
   the roofline of the flagship bf16 predict, the `--amp` train step and
   the `--fwd-dtype int8` step at b16 512^2, each device operation
   joined to the row of the counted operation that launched it
   (unattributed at most 1% of busy, the rows adding up to busy within
   0.5%), each hand kernel one row with the calls `expected_launches`
   derives, at least as many device operations and the bytes of
   `SITE_MOVES`' rule, no row outside the L2 above 105% of its roofline,
   the predict's conv FLOPs equal to `quality/cost.py`'s; the top rows,
   the class table, MFU and idle share; the breakdown's components (MFU
   and HBM utilisation at most 105%); and the trace summary of 26's
   `--profile` trace (run beside 26's eval CLI: the train kernels #4-#13
   named, each kernel stream busy in (0, 1]).

The phases run in the order of PHASES, not of this list: the export
workers compile beside the phases that record no kernel or predict
time, and every phase that times the card runs after them.

Every phase must close or reap the threads and processes it starts:
one left behind fails the run after the last phase (`leftovers`), but
for the export workers, which phase export waits for (`BACKGROUND`). The
script makes itself the subreaper of its descendants, so a grandchild
orphaned by its parent (a job's workers, a compile pool's sidecar) is
seen as its child; each phase's left processes get a grace to end, and
before the result lines no process the script started may still run. A
failed phase, SIGTERM, SIGHUP or SIGINT kills what is left (each job's
process group with it) before the script exits.

`--phases variants` (or any comma-separated subset; `identity` always
runs) runs phases alone. Any failure exits non-zero. Each phase prints
its wall time. The last
three lines are the card's name and power limit, one JSON object of
per-kernel numbers (all 13 TPU kernels, the int8 kernels #14-#16 with
their launches in an int8 train step beside, and the abs-max), and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import io
import json
import math
import os
import re
import shlex
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# The run order: export_compile starts the exports' AOTInductor compiles
# (phase export's worker processes, CPU work at the lowest priority);
# the phases that record no kernel or predict time run beside them, and
# every phase that times the card runs after they have ended (they take
# about 170 s; the phases before `timing` about 300 s)
PHASES = ("identity", "build", "export_compile", "kernels", "states",
          "train_kernels", "loss_kernels", "variants_small", "nms", "cli",
          "train_cli", "supervisor", "analysis", "quality", "variants",
          "variants_train", "timing", "main", "train_timing", "loss_timing",
          "train_main", "accum", "ddp", "train_extras", "train_runtime",
          "eval_grad", "eval_timing", "serve", "qkernels", "qtiming", "int8",
          "serve_int8", "fleet", "cascade", "streams", "serve_bench",
          "export", "report", "roofline")
# child processes that outlive the phase that started them (phase
# export's workers, {pid: Popen}): no phase counts them as its leftovers
BACKGROUND = {}
EXPORT_BG = {}  # "root", "workers" of phase export_compile


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- helpers


def rand(shape, dtype, gen, scale=1.0):
    import torch
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def channels_last(t):
    import torch
    return t.contiguous(memory_format=torch.channels_last)


def bf16_ulp(ref):
    """One bf16 unit in the last place of each reference value."""
    import torch
    _, e = torch.frexp(ref.float())
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - 8)


def nan_equal(got, want):
    """Equal values, NaN where the other has NaN."""
    import torch
    nan = torch.isnan(got)
    return bool(torch.equal(nan, torch.isnan(want))
                and torch.equal(got.masked_fill(nan, 0),
                                want.masked_fill(nan, 0)))


def compare(name, got, want, mode):
    """mode: 'equal' (torch.equal) | 'nan_equal' (equal, NaN where the
    other has NaN: for inputs that hold NaN) | 'rtol1e-6' | 'bf16ulp'.
    Returns the max abs error over the cells not NaN in both (NaN if one
    is)."""
    import torch
    torch.cuda.synchronize()
    require(got.shape == want.shape and got.dtype == want.dtype,
            "%s: shape/dtype %s %s vs %s %s" % (name, tuple(got.shape),
                                                got.dtype, tuple(want.shape),
                                                want.dtype))
    g, w = got.float(), want.float()
    d = torch.where(g == w, torch.zeros_like(g), (g - w).abs())
    d = d[~(torch.isnan(g) & torch.isnan(w))]
    err = float(d.max()) if d.numel() else 0.0
    if mode == "equal":
        ok = torch.equal(got, want)
    elif mode == "nan_equal":
        ok = nan_equal(got, want)
    elif mode == "rtol1e-6":
        ok = bool(((g - w).abs() <= 1e-6 * w.abs() + 1e-30).all())
    else:
        ok = bool(((g - w).abs() <= bf16_ulp(w)).all())
    require(ok, "%s: kernel disagrees with its plain version (%s, max abs "
                "err %g)" % (name, mode, err))
    return err


def graph_ms(fn, calls=10, replays=5):
    """Device time of one fn() call: `calls` calls captured in one CUDA
    graph, replayed `replays` times between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (calls * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


def eager_ms(fn, iters=20):
    """Stream time of one fn() call issued eagerly from Python (includes
    any host overhead the device waits on)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters=50):
    """Host time (microseconds) of issuing one fn() call from Python: the
    wrapper's checks, plan and launch, `iters` calls after a sync, the
    device queue far from full."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / iters


@contextlib.contextmanager
def swapped(swaps, value=None):
    """Set each (module, name) to its stand-in while the block runs (the
    model, the train passes and predict call the wrappers through their
    modules); yields `value`."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield value
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_kernels():
    """Every kernel wrapper of the paths swapped for its plain version."""
    from real_time_helmet_detection_tpu_torch.ops import (epilogue, loss,
                                                          peak, qconv,
                                                          residual)
    return swapped([
        (qconv, "quantize_act", qconv.quantize_act_reference),
        (qconv, "abs_max", qconv.abs_max_reference),
        (qconv, "conv_dense", qconv.conv_dense_reference),
        (qconv, "conv_dw", qconv.conv_dw_reference),
        (loss, "loss_sums", loss.loss_sums_reference),
        (loss, "loss_sums_bwd", loss.loss_sums_bwd_reference),
        (epilogue, "bn_eval_bwd", epilogue.bn_eval_bwd_reference),
        (residual, "bn_add_eval_bwd", residual.bn_add_eval_bwd_reference),
        (epilogue, "bn_act", epilogue.bn_act_reference),
        (residual, "bn_add_act", residual.bn_add_act_reference),
        (peak, "peak_scores", peak.peak_scores_reference),
        (epilogue, "bn_stats", epilogue.bn_stats_reference),
        (epilogue, "bn_bwd_sums", epilogue.bn_bwd_sums_reference),
        (epilogue, "bn_bwd_dx",
         lambda *a: epilogue.bn_bwd_dx_reference(*a)[0]),
        (residual, "bn_add_bwd_sums", residual.bn_add_bwd_sums_reference),
        (residual, "bn_add_bwd_dx", residual.bn_add_bwd_dx_reference),
    ])


# every launch counter: name in the kernels line -> (module, attribute)
COUNTERS = {
    "peak_scores": ("peak", "launches"),
    "peak_vec": ("peak", "vector_launches"),
    "peak_scalar": ("peak", "scalar_launches"),
    "bn_act": ("epilogue", "launches"),
    "bn_act_vec": ("epilogue", "vector_launches"),
    "bn_act_scalar": ("epilogue", "scalar_launches"),
    "bn_add_act": ("residual", "launches"),
    "bn_stats": ("epilogue", "stats_launches"),
    "bn_bwd_sums": ("epilogue", "bwd_sums_launches"),
    "bn_add_bwd_sums": ("residual", "bwd_sums_launches"),
    "bn_bwd_dx": ("epilogue", "bwd_dx_launches"),
    "bn_add_bwd_dx": ("residual", "bwd_dx_launches"),
    "bn_eval_bwd": ("epilogue", "eval_bwd_launches"),
    "bn_add_eval_bwd": ("residual", "eval_bwd_launches"),
    "loss_fwd": ("loss", "fwd_launches"),
    "loss_bwd": ("loss", "bwd_launches"),
    "loss_bwd_vec": ("loss", "bwd_vector_launches"),
    "loss_bwd_scalar": ("loss", "bwd_scalar_launches"),
    "quantize_act": ("qconv", "quant_launches"),
    "quantize_act_dual": ("qconv", "quant_dual_launches"),
    "abs_max": ("qconv", "absmax_launches"),
    "qconv_dense": ("qconv", "dense_launches"),
    "qconv_dense_wgmma": ("qconv", "dense_wgmma_launches"),
    "qconv_dense_mma": ("qconv", "dense_mma_launches"),
    "qconv_dense_codes": ("qconv", "dense_code_launches"),
    "qconv_dw": ("qconv", "dw_launches"),
    "qconv_dw_tiled": ("qconv", "dw_tiled_launches"),
    "qconv_dw_gather": ("qconv", "dw_gather_launches"),
    "qconv_dw_codes": ("qconv", "dw_code_launches"),
}


# the configurations of phases variants, variants_train and nms, at b16
# 512^2: the architecture fields of the JAX package's edge tier (ghost,
# width 64, stem width 64) and quality tier (2 stacks, soft-NMS; ref
# config.py:74-76, :82-84), the depthwise variant and the other options at
# the flagship's width
VARIANT_CONFIGS = {
    "edge-arch": dict(variant="ghost", hourglass_inch=64, stem_width=64),
    "quality-arch": dict(num_stack=2, hourglass_inch=128, nms="soft-nms"),
    "depthwise-128": dict(variant="depthwise"),
    "options": dict(activation="PReLU", neck_activation="Mish", pool="Conv",
                    neck_pool="SPP", stem_s2d=True),
}
# the options of phase variants_small, each at 128^2, width 32
SMALL_CONFIGS = {
    "pool-avg": dict(pool="Avg"), "pool-spp": dict(pool="SPP"),
    "lrelu": dict(activation="LReLU"), "sigmoid": dict(activation="Sigmoid"),
    "celu": dict(activation="CELU", neck_activation="CELU"),
    "mish": dict(activation="Mish"), "nms-maxpool": dict(nms="maxpool"),
}

PARTS = ("pre", "stacks", "necks")  # the stem + PreLayer, the hourglass
# stacks, each stack's neck


def bn_sites(cfg, parts=PARTS):
    """(channel counts of the epilogue sites, channel counts of the fused
    residual-tail sites) of one forward of cfg's model, derived from the
    architecture (ref models/hourglass.py:564-863): a BN'd conv is an
    epilogue site, except the tail conv of a residual or depthwise block
    whose post-add activation the kernels take (hourglass.py:650-654),
    which is a tail site; a ghost module is two BN'd convs of half the
    width; the PreLayer's and the neck's blocks are ReLU. `parts` picks
    the parts of the model counted (`--remat stacks` reruns "stacks")."""
    from real_time_helmet_detection_tpu_torch.ops.epilogue import \
        ACTIVATIONS as KERNEL_ACTIVATIONS
    epi, tail = [], []

    def residual(cin, cout, act):
        v = cfg.variant
        body = {"residual": [cout, cout], "depthwise": [cin, cout, cout, cout],
                "ghost": [cout // 2] * 4}[v]
        if cin != cout:
            body.append(cout)  # the skip's 1x1 projection
        if v != "ghost" and act in KERNEL_ACTIVATIONS:
            tail.append(body.pop(1 if v == "residual" else 3))
        epi.extend(body)

    def hourglass(n, c):
        m = c + cfg.increase_ch
        residual(c, c, cfg.activation)
        residual(c, m, cfg.activation)
        if n > 1:
            hourglass(n - 1, m)
        else:
            residual(m, m, cfg.activation)
        residual(m, c, cfg.activation)

    width, mid = cfg.hourglass_inch, cfg.stem_width or 128
    if "pre" in parts:
        epi.append(64)  # the stem conv
        for cin, cout in ((64, mid), (mid, mid), (mid, width)):
            residual(cin, cout, "ReLU")
    for _ in range(cfg.num_stack):
        if "stacks" in parts:
            hourglass(4, width)
        if "necks" in parts:
            epi.append(width)  # the neck conv
            residual(width, width, "ReLU")
    return epi, tail


def qconv_sites(cfg):
    """(dense int8 convs, depthwise int8 convs) of one forward of cfg's
    int8 twin, derived from the architecture (ref models/hourglass.py:
    500-561, :825-828): every BN'd conv but the stem is a QuantConv; a
    residual block is two dense 3x3, a depthwise block two depthwise 3x3
    and two pointwise 1x1, a ghost block two ghost modules of a 1x1 and a
    depthwise 3x3 each, + the 1x1 projection where the width changes; the
    neck conv is a 1x1."""
    dense, dw_channels = qconv_walk(cfg)
    return dense, len(dw_channels)


def walk_blocks(cfg, parts=PARTS):
    """(input width, output width, activation) of each residual block of
    one forward of cfg's model, in order, and the number of neck convs
    (`parts` as in `bn_sites`): the PreLayer's and the necks' blocks take
    ReLU, the hourglass blocks cfg.activation (ref models/hourglass.py:
    793-863)."""
    blocks, necks = [], 0

    def hourglass(n, c):
        m = c + cfg.increase_ch
        blocks.extend([(c, c, cfg.activation), (c, m, cfg.activation)])
        if n > 1:
            hourglass(n - 1, m)
        else:
            blocks.append((m, m, cfg.activation))
        blocks.append((m, c, cfg.activation))

    width, mid = cfg.hourglass_inch, cfg.stem_width or 128
    if "pre" in parts:
        blocks.extend((cin, cout, "ReLU") for cin, cout in
                      ((64, mid), (mid, mid), (mid, width)))
    for _ in range(cfg.num_stack):
        if "stacks" in parts:
            hourglass(4, width)
        if "necks" in parts:
            necks += 1
            blocks.append((width, width, "ReLU"))
    return blocks, necks


def block_convs(cfg, cin, cout):
    """(dense int8 convs, channel counts of the depthwise ones) of one
    residual block of cfg's variant."""
    dense = 2 + (cin != cout)
    dw = {"depthwise": [cin, cout], "ghost": [cout // 2] * 2}.get(
        cfg.variant, [])
    return dense, dw


def qconv_walk(cfg, parts=PARTS, neck_conv=True):
    """(dense int8 convs, the channel count of each depthwise int8 conv)
    of one forward of cfg's int8 twin (see `qconv_sites`): a depthwise
    block's depthwise convs take its input and output widths, a ghost
    module's its half width. `parts` as in `bn_sites`; `neck_conv` False
    leaves out the neck's 1x1 conv (it has a bias: no STE site)."""
    blocks, necks = walk_blocks(cfg, parts)
    dense, dw = necks * neck_conv, []
    for cin, cout, _ in blocks:
        d, c = block_convs(cfg, cin, cout)
        dense += d
        dw.extend(c)
    return dense, dw


def fuses_codes(cfg, activation):
    """Does a residual block of cfg's int8 twin with `activation` write
    its convs' input codes in their producers' epilogues
    (`models.hourglass.Residual.fuse_codes`)?"""
    return cfg.variant in ("residual", "ghost") and activation in (
        "ReLU", "Linear")


def quant_walk(cfg, parts=PARTS):
    """(quantizer launches, of which at two steps) of one predict of cfg's
    int8 twin: a block that fuses its codes (`fuses_codes`) quantizes its
    input once, at two steps where a projection takes it too; any other
    block once per int8 conv; each neck conv once."""
    blocks, necks = walk_blocks(cfg, parts)
    launches, dual = necks, 0
    for cin, cout, act in blocks:
        if fuses_codes(cfg, act):
            launches += 1
            dual += cin != cout
        else:
            d, c = block_convs(cfg, cin, cout)
            launches += d + len(c)
    return launches, dual


def code_walk(cfg, parts=PARTS):
    """(dense, depthwise) int8 conv launches of one predict of cfg's int8
    twin that write codes: in a fusing block the residual variant's
    `Convolution_0`, or each ghost module's 1x1 and `GhostModule_0`'s
    depthwise conv."""
    blocks, _ = walk_blocks(cfg, parts)
    fused = sum(fuses_codes(cfg, act) for _, _, act in blocks)
    if cfg.variant == "ghost":
        return 2 * fused, fused
    return fused, 0


def ste_walk(cfg, parts=PARTS):
    """(dense STE convs, the channel count of each depthwise STE conv) of
    one `--fwd-dtype int8` train forward of cfg's model: every BN'd,
    bias-free conv but the stem (ref models/hourglass.py:516-535), i.e.
    `qconv_walk`'s sites less each neck's 1x1 conv."""
    return qconv_walk(cfg, parts, neck_conv=False)


def int8_launches(dense, dw_channels, quant=None, dual=0, codes=(0, 0)):
    """The quantizer and int8 conv counters of `dense` dense convs and a
    depthwise conv at each of `dw_channels`, each on the kernel its plan
    takes (`dense_plan`: the wgmma kernel for every shape; `dw_plan`: the
    tiled kernel for C % 16 == 0): `quant` quantizer launches (default
    one a conv), `dual` of them at two steps, `codes` (dense, depthwise)
    conv launches that write codes."""
    from real_time_helmet_detection_tpu_torch.ops import qconv
    dw = len(dw_channels)
    tiled = sum(qconv.dw_plan(1, 1, 1, c).variant == "tiled"
                for c in dw_channels)
    return dict(quantize_act=dense + dw if quant is None else quant,
                quantize_act_dual=dual, qconv_dense=dense,
                qconv_dense_wgmma=dense, qconv_dense_codes=codes[0],
                qconv_dw=dw, qconv_dw_tiled=tiled,
                qconv_dw_gather=dw - tiled, qconv_dw_codes=codes[1])


def expected_launches(cfg, path, dtype):
    """Every launch counter after one predict ("predict"), one train step
    ("train") or one eval-mode loss + backward ("eval_grad") of cfg's
    model at cfg.imsize with activations of `dtype`: bn_sites' counts, the
    epilogue's variant per site from `bn_act_variant` (fresh, aligned
    tensors), the peak test once and the loss kernels once each way, each
    on the variant its shape takes. An int8 predict (`cfg.infer_dtype`)
    runs no BN kernel: an int8 conv at each of `qconv_sites`, each on
    the kernel its plan takes (`dense_plan`: the wgmma kernel for every
    shape; `dw_plan`: the tiled kernel for C % 16 == 0), those that write
    their consumers' codes (`code_walk`), the quantizer where no int8 conv
    writes a conv's input codes (`quant_walk`), and the peak test. An
    `--fwd-dtype int8` step adds the abs-max and the quantizer at each STE
    site."""
    import torch
    from real_time_helmet_detection_tpu_torch.ops import (epilogue, loss,
                                                          peak)
    epi, tail = bn_sites(cfg)
    vec = sum(epilogue.bn_act_variant(c, dtype) == "vector" for c in epi)
    want = dict.fromkeys(COUNTERS, 0)
    if getattr(cfg, "infer_dtype", "bf16") == "int8":
        want.update(int8_launches(*qconv_walk(cfg), *quant_walk(cfg),
                                  codes=code_walk(cfg)))
    else:
        want.update(bn_act=len(epi), bn_act_vec=vec,
                    bn_act_scalar=len(epi) - vec, bn_add_act=len(tail))
    side = cfg.imsize // (2 if cfg.pool in ("SPP", "None") else 4)
    k = cfg.num_cls + 4
    if path == "predict":
        pv = peak.peak_variant(cfg.num_cls, k, side, 0, 0)
        want["peak_scores"] = 1
        want["peak_vec" if pv == "vector" else "peak_scalar"] = 1
        return want
    lv = loss.bwd_variant(side * side, cfg.num_cls, torch.float32)
    want.update(loss_fwd=1, loss_bwd=1)
    want["loss_bwd_vec" if lv == "vector" else "loss_bwd_scalar"] = 1
    if path == "train":
        want.update(bn_stats=len(epi) + len(tail), bn_bwd_sums=len(epi),
                    bn_bwd_dx=len(epi), bn_add_bwd_sums=len(tail),
                    bn_add_bwd_dx=len(tail))
        if getattr(cfg, "fwd_dtype", "bf16") == "int8":
            dense, dw = ste_walk(cfg)
            want.update(int8_launches(dense, dw),
                        abs_max=dense + len(dw))
        # the forward launches a recompute reruns (`--remat`)
        again = {"stacks": ("stacks",), "full": PARTS}.get(
            getattr(cfg, "remat", "none"), ())
        if again:
            r_epi, r_tail = bn_sites(cfg, again)
            r_vec = sum(epilogue.bn_act_variant(c, dtype) == "vector"
                        for c in r_epi)
            extra = dict(bn_act=len(r_epi), bn_act_vec=r_vec,
                         bn_act_scalar=len(r_epi) - r_vec,
                         bn_add_act=len(r_tail),
                         bn_stats=len(r_epi) + len(r_tail))
            if getattr(cfg, "fwd_dtype", "bf16") == "int8":
                dense, dw = ste_walk(cfg, again)
                extra.update(int8_launches(dense, dw),
                             abs_max=dense + len(dw))
            for key, n in extra.items():
                want[key] += n
    else:
        want.update(bn_eval_bwd=len(epi), bn_add_eval_bwd=len(tail))
    return want


def _ops():
    from real_time_helmet_detection_tpu_torch import ops
    from real_time_helmet_detection_tpu_torch.ops import (  # noqa: F401
        epilogue, loss, peak, qconv, residual)
    return ops


def reset_counts():
    ops = _ops()
    for mod, attr in COUNTERS.values():
        setattr(getattr(ops, mod), attr, 0)
    ops.epilogue.grad_conversions = 0


def read_counts():
    ops = _ops()
    return {name: getattr(getattr(ops, mod), attr)
            for name, (mod, attr) in COUNTERS.items()}


def box_iou(box, boxes):
    """IoU of one box against (N, 4) boxes, corners put in order first (a
    raw size regression can emit inverted boxes)."""
    import numpy as np
    box = np.concatenate([np.minimum(box[:2], box[2:]),
                          np.maximum(box[:2], box[2:])])
    boxes = np.concatenate([np.minimum(boxes[:, :2], boxes[:, 2:]),
                            np.maximum(boxes[:, :2], boxes[:, 2:])], 1)
    wh = np.clip(np.minimum(box[2:], boxes[:, 2:])
                 - np.maximum(box[:2], boxes[:, :2]), 0, None)
    inter = wh[:, 0] * wh[:, 1]
    union = ((box[2] - box[0]) * (box[3] - box[1])
             + (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
             - inter)
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def match_misses(a, b, min_score=0.1):
    """(detections checked, the misses (box, class, score, image)): every
    valid detection scoring >= min_score in `a` should have one in `b`
    with the same class, |score difference| <= 1e-3 and IoU >= 0.99 (or,
    for a box of zero area, corners within 1e-2)."""
    import numpy as np
    checked, misses = 0, []
    a = [t.cpu().numpy() for t in a]
    b = [t.cpu().numpy() for t in b]
    for i in range(a[0].shape[0]):
        sel_a = a[3][i] & (a[2][i] >= min_score)
        sel_b = b[3][i] & (b[2][i] >= min_score - 1e-3)
        bb, bc, bs = b[0][i][sel_b], b[1][i][sel_b], b[2][i][sel_b]
        for box, c, s in zip(a[0][i][sel_a], a[1][i][sel_a], a[2][i][sel_a]):
            checked += 1
            close = (box_iou(box, bb) >= 0.99) | (
                np.abs(bb - box).max(axis=1, initial=0) <= 1e-2)
            if not ((bc == c) & (np.abs(bs - s) <= 1e-3) & close).any():
                misses.append((box, c, s, i))
    return checked, misses


def detections_match(a, b, min_score=0.1):
    """`match_misses` with no miss allowed. Returns the number of
    detections checked."""
    checked, misses = match_misses(a, b, min_score)
    if misses:
        box, c, s, i = misses[0]
        require(False, "detection %s cls %d score %.4f of image %d has no "
                "match (%d of %d missed)" % (box, c, s, i, len(misses),
                                              checked))
    return checked


# ----------------------------------------------------------------- phases


def phase_identity(state):
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, "nvidia-smi failed: %s" % smi.stderr)
    state["card"] = smi.stdout.strip().splitlines()[0]
    state["kind"] = name
    log("card: torch %s, CUDA %s, %s | nvidia-smi: %s"
        % (torch.__version__, torch.version.cuda, name, state["card"]))


def phase_build(state):
    from real_time_helmet_detection_tpu_torch.ops import _build
    t0 = time.time()
    logs = _build.build()
    log("build: %d kernel libraries in %.1f s -> %s"
        % (len(logs), time.time() - t0, _build.BUILD_DIR))
    for name, text in logs.items():
        # ptxas reports, per entry: its mangled name, then the stack frame
        # and spill bytes, then registers / shared memory
        entry = None
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif entry and ("spill" in line or "Used" in line):
                log("  [%s] %s: %s" % (name, entry,
                                       line.split(":", 1)[-1].strip()))
    for name in logs:
        _build.load(name)


# main-path activation shapes at batch 16, 512^2, 128 channels: the stem
# epilogue at 256^2 x 64, then 128 channels at every hourglass level
EPI_SHAPES = [(16, 64, 256, 256)] + [(16, 128, s, s)
                                     for s in (256, 128, 64, 32, 16, 8)]
RES_SHAPES = [(16, 128, s, s) for s in (256, 128, 64, 32, 16, 8)]
PEAK_SHAPE = (16, 1, 128, 128, 6)
# the peak kernel off the flagship's shape: (shape, classes, pool sizes,
# variant): ragged tiles on the vector variant (h % 16, w % 32 != 0), a
# pool of 81 (110.6 KB of shared memory, past the 48 KB default), and the
# scalar variant for w % 4 != 0 and three classes
PEAK_OTHER = [((2, 1, 37, 44, 6), 2, (3, 5, 81), "vector"),
              ((2, 1, 37, 46, 6), 2, (3, 5), "scalar"),
              ((2, 2, 37, 44, 7), 3, (3, 5, 81), "scalar")]
# the epilogue off the flagship's sites: element counts that are no
# multiple of V x the unroll (C 8, 64, 128: the vector kernel's tail
# loop) and C = 6 (the scalar kernel); (shape, variant)
EPI_RAGGED = [((3, c, 5, 7), "vector") for c in (8, 64, 128)] \
    + [((3, 6, 5, 7), "scalar")]


def misaligned(shape, dtype, gen):
    """A channels-last tensor one element into its storage, so its data
    is not 16-byte aligned."""
    import torch
    n, c, h, w = shape
    base = rand((n * h * w * c + 1,), dtype, gen, 2.0)
    return base[1:].view(n, h, w, c).permute(0, 3, 1, 2)


def nonfinite(t, gen, share=0.002):
    """t with a seeded `share` of its values each set to NaN, +inf and
    -inf."""
    import torch
    u = torch.rand(t.shape, generator=gen, device=t.device)
    t = t.masked_fill(u < share, float("nan"))
    t = t.masked_fill((u >= share) & (u < 2 * share), float("inf"))
    return t.masked_fill((u >= 2 * share) & (u < 3 * share), float("-inf"))


def peak_case(label, logits, num_cls, pool_size, variant):
    """The peak kernel on `logits` against its plain version, bit-equal,
    on the variant it should take. Returns the max abs error. The output
    holds no NaN even where the logits do (a window holding a NaN scores
    0), so torch.equal is the NaN-aware test here."""
    from real_time_helmet_detection_tpu_torch.ops import peak
    before = (peak.vector_launches, peak.scalar_launches)
    got = peak.peak_scores(logits, num_cls, pool_size)
    took = "vector" if peak.vector_launches > before[0] \
        else "scalar" if peak.scalar_launches > before[1] else None
    name = "peak_scores pool %d %s" % (pool_size, label)
    require(took == variant, "%s ran the %s variant, want %s"
            % (name, took, variant))
    return compare(name, got,
                   peak.peak_scores_reference(logits, num_cls, pool_size),
                   "equal")


def phase_kernels(state):
    import torch
    from real_time_helmet_detection_tpu_torch.ops import (epilogue, peak,
                                                          residual)
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = state.setdefault("errs", {})
    n = 0
    epi_cases = [(s, "vector", False) for s in EPI_SHAPES] \
        + [(s, v, False) for s, v in EPI_RAGGED] \
        + [((2, 64, 9, 9), "scalar", True)]
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for act in ("ReLU", "Linear", "Mish"):
            mode = ("equal" if act != "Mish" else
                    "rtol1e-6" if dtype == torch.float32 else "bf16ulp")
            for shape, variant, offset in epi_cases:
                x = misaligned(shape, dtype, gen) if offset else \
                    channels_last(rand(shape, dtype, gen, 2.0))
                a = rand((shape[1],), torch.float32, gen, 0.5) + 1.0
                b = rand((shape[1],), torch.float32, gen, 0.5)
                label = "bn_act %s %s %s%s" % (tag, act, shape,
                                               " misaligned" * offset)
                before = (epilogue.vector_launches, epilogue.scalar_launches)
                got = epilogue.bn_act(x, a, b, act)
                took = "vector" if epilogue.vector_launches > before[0] \
                    else "scalar" if epilogue.scalar_launches > before[1] \
                    else None
                require(took == variant, "%s ran the %s kernel, want %s"
                        % (label, took, variant))
                err = compare(label, got,
                              epilogue.bn_act_reference(x, a, b, act), mode)
                errs[("bn_act", tag, act, shape) + ("misaligned",) * offset] \
                    = err
                n += 1
            for shape in RES_SHAPES:
                y = channels_last(rand(shape, dtype, gen, 2.0))
                s = channels_last(rand(shape, dtype, gen, 1.0))
                a = rand((shape[1],), torch.float32, gen, 0.5) + 1.0
                b = rand((shape[1],), torch.float32, gen, 0.5)
                err = compare("bn_add_act %s %s %s" % (tag, act, shape),
                              residual.bn_add_act(y, a, b, s, act),
                              residual.bn_add_act_reference(y, a, b, s, act),
                              mode)
                errs[("bn_add_act", tag, act, shape)] = err
                n += 1
    for pool_size in (3, 5):
        for label, logits in (
                ("normal", rand(PEAK_SHAPE, torch.float32, gen, 3.0)),
                # coarse values: plateaus, so ties decide peaks
                ("plateau", torch.round(rand(PEAK_SHAPE, torch.float32,
                                             gen, 2.0)) / 2),
                # saturated sigmoid: distinct logits, equal scores
                ("saturated", rand(PEAK_SHAPE, torch.float32, gen, 4.0)
                 + 30.0),
                # a diverged model: NaN and +-inf among the logits
                ("nan-inf", nonfinite(rand(PEAK_SHAPE, torch.float32, gen,
                                           3.0), gen))):
            errs[("peak_scores", pool_size, label)] = peak_case(
                label, logits, 2, pool_size, "vector")
            n += 1
    for shape, num_cls, pools, variant in PEAK_OTHER:
        logits = nonfinite(rand(shape, torch.float32, gen, 3.0), gen, 0.01)
        for pool_size in pools:
            errs[("peak_scores", pool_size, shape)] = peak_case(
                "%s nan-inf" % (shape,), logits, num_cls, pool_size, variant)
            n += 1
    # logits one element into their storage: not 8-byte aligned
    base = rand((math.prod(PEAK_SHAPE) + 1,), torch.float32, gen, 3.0)
    for pool_size in (3, 5):
        errs[("peak_scores", pool_size, "misaligned")] = peak_case(
            "misaligned", base[1:].view(PEAK_SHAPE), 2, pool_size, "scalar")
        n += 1
    def mish_err(name, tag):
        return max(v for k, v in errs.items() if k[:3] == (name, tag, "Mish"))

    log("kernels: %d comparisons against the plain versions passed, the "
        "epilogue on its vector kernel at every EPI_SHAPES site and at %s, "
        "on its scalar kernel at %s and on a misaligned (2, 64, 9, 9) view; "
        "the peak test with NaN and +-inf logits, on its vector variant at "
        "%s and on its scalar one at %s and misaligned logits "
        "(max abs err: bn_act Mish f32 %g, bf16 %g; bn_add_act Mish f32 "
        "%g, bf16 %g; all others 0)"
        % (n, [s for s, v in EPI_RAGGED if v == "vector"],
           [s for s, v in EPI_RAGGED if v == "scalar"],
           [PEAK_SHAPE] + [c[0] for c in PEAK_OTHER if c[3] == "vector"],
           [c[0] for c in PEAK_OTHER if c[3] == "scalar"],
           mish_err("bn_act", "f32"), mish_err("bn_act", "bf16"),
           mish_err("bn_add_act", "f32"), mish_err("bn_add_act", "bf16")))
    require(all(v == 0.0 for k, v in errs.items() if "Mish" not in k),
            "a bit-equal comparison reported a non-zero error")


def phase_timing(state):
    import torch
    from real_time_helmet_detection_tpu_torch.ops import (epilogue, peak,
                                                          residual)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = state.setdefault("timing", {})
    shape = (16, 128, 256, 256)  # the largest epilogue / tail site
    log("timing (ms per call; kernel and plain by CUDA graph replay, "
        "eager = issued from Python):")
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        x = channels_last(rand(shape, dtype, gen))
        s = channels_last(rand(shape, dtype, gen))
        a = rand((shape[1],), torch.float32, gen) + 1.0
        b = rand((shape[1],), torch.float32, gen)
        a4, b4 = a.view(1, -1, 1, 1), b.view(1, -1, 1, 1)
        nbytes = x.numel() * x.element_size()
        for act in ("ReLU", "Linear", "Mish"):
            lib = None
            if act == "Linear":
                lib = graph_ms(lambda: torch.addcmul(b4, x, a4))
            rows[("bn_act", tag, act)] = dict(
                ms=graph_ms(lambda: epilogue.bn_act(x, a, b, act)),
                eager_ms=eager_ms(lambda: epilogue.bn_act(x, a, b, act)),
                plain_ms=graph_ms(
                    lambda: epilogue.bn_act_reference(x, a, b, act)),
                library_ms=lib, bound_ms=2 * nbytes / HBM_BYTES_PER_S * 1e3,
                shape=shape)
            rows[("bn_add_act", tag, act)] = dict(
                ms=graph_ms(lambda: residual.bn_add_act(x, a, b, s, act)),
                eager_ms=eager_ms(
                    lambda: residual.bn_add_act(x, a, b, s, act)),
                plain_ms=graph_ms(lambda: residual.bn_add_act_reference(
                    x, a, b, s, act)),
                library_ms=None, bound_ms=3 * nbytes / HBM_BYTES_PER_S * 1e3,
                shape=shape)
        del x, s
    logits = rand(PEAK_SHAPE, torch.float32, gen, 3.0)
    pbytes = 2 * (logits[..., :2].numel() * 4)  # 2 heat channels in + out
    # the bytes the layout forces: every 32-byte sector of the logits holds
    # a heat pair, so all of the logits cross, and the output
    forced = (logits.numel() + logits[..., :2].numel()) * 4
    for pool_size in (3, 5):
        rows[("peak_scores", "f32", pool_size)] = dict(
            ms=graph_ms(lambda: peak.peak_scores(logits, 2, pool_size)),
            eager_ms=eager_ms(lambda: peak.peak_scores(logits, 2, pool_size)),
            plain_ms=graph_ms(
                lambda: peak.peak_scores_reference(logits, 2, pool_size)),
            library_ms=None, bound_ms=pbytes / HBM_BYTES_PER_S * 1e3,
            forced_ms=forced / HBM_BYTES_PER_S * 1e3, shape=PEAK_SHAPE,
            scalar_ms=graph_ms(lambda: peak.peak_scores(
                logits, 2, pool_size, variant="scalar")))
    # what moving the heat channels alone costs here: the kernel at pool
    # size 1 (staging, sigmoid, stores; no window) and one PyTorch copy
    # that gathers them class-major
    rows[("peak_scores", "f32", 3)].update(
        pool1_ms=graph_ms(lambda: peak.peak_scores(logits, 2, 1)),
        copy_ms=graph_ms(lambda: logits[..., :2].permute(
            0, 1, 4, 2, 3).contiguous()))
    for key, r in rows.items():
        log("  %-36s kernel %.4f (eager %.4f)  plain %.4f  library %s  "
            "bound %.4f%s  at %s" % (
                "%s %s %s" % key, r["ms"], r["eager_ms"], r["plain_ms"],
                "%.4f" % r["library_ms"] if r["library_ms"] is not None
                else "none", r["bound_ms"],
                " (the bytes the layout forces: %.4f; the scalar variant "
                "%.4f)" % (r["forced_ms"], r["scalar_ms"])
                if "forced_ms" in r else "", r["shape"]))
    r = rows[("peak_scores", "f32", 3)]
    log("  peak_scores f32 at pool size 1 (no window) %.4f; the heat "
        "channels gathered class-major by one PyTorch copy %.4f"
        % (r["pool1_ms"], r["copy_ms"]))
    epilogue_sweep(state)


def epilogue_sweep(state):
    """The epilogue's vector kernel against its scalar kernel (the earlier
    design, still built) at every EPI_SHAPES site, ReLU, f32 and bf16, by
    CUDA graph replay in turns (vector, scalar, scalar, vector; each the
    mean of its two), beside the bound (bytes / 3.35 TB/s)."""
    import torch
    from real_time_helmet_detection_tpu_torch.ops import epilogue
    gen = torch.Generator(device="cuda").manual_seed(8)
    sweep = state.setdefault("epi_sweep", {})
    log("epilogue sweep (ReLU, ms per call by CUDA graph replay; vector = "
        "16-byte kernel, scalar = the one-element-a-thread kernel):")
    for dtype in (torch.bfloat16, torch.float32):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for shape in EPI_SHAPES:
            x = channels_last(rand(shape, dtype, gen))
            a = rand((shape[1],), torch.float32, gen) + 1.0
            b = rand((shape[1],), torch.float32, gen)
            times = {"vector": [], "scalar": []}
            for variant in ("vector", "scalar", "scalar", "vector"):
                times[variant].append(graph_ms(
                    lambda: epilogue.bn_act(x, a, b, "ReLU",
                                            variant=variant)))
            r = {k: sum(v) / len(v) for k, v in times.items()}
            r["bound"] = 2 * x.numel() * x.element_size() \
                / HBM_BYTES_PER_S * 1e3
            sweep[(tag, shape)] = r
            log("  %-4s %-20s vector %.4f (%.0f%% of bound)  scalar %.4f "
                "(%.0f%%)  bound %.4f  vector/scalar %.3f" % (
                    tag, shape, r["vector"], 100 * r["bound"] / r["vector"],
                    r["scalar"], 100 * r["bound"] / r["scalar"], r["bound"],
                    r["vector"] / r["scalar"]))
            del x
        torch.cuda.empty_cache()
    big = [k for k in sweep if k[1][2] >= 128]
    small = [k for k in sweep if k[1][2] < 128]
    log("epilogue sweep: vector faster than scalar at every 256^2 and "
        "128^2 site %s; vector within 5%% of scalar at every smaller site "
        "%s" % (all(sweep[k]["vector"] < sweep[k]["scalar"] for k in big),
                all(sweep[k]["vector"] <= 1.05 * sweep[k]["scalar"]
                    for k in small)))


def perturb_bn(model, seed, scale=(0.2, 0.6)):
    """Non-trivial BN state from a seeded generator, so the fold matters;
    BN scales uniform in `scale`."""
    import torch
    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        BatchNorm
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.numel()
                # scales below 1 keep the random net's logits O(1), as a
                # trained net's are, so scores do not all saturate at 1
                lo, hi = scale
                m.weight.copy_(torch.rand(c, generator=gen) * (hi - lo) + lo)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return model


def throughput(predict, images, windows=5, window_s=2.0, min_predicts=10):
    """Predict images/s of the kernel path and of the plain-version path,
    in `windows` alternating windows of about `window_s` seconds and at
    least `min_predicts` predicts each (so host noise falls on both
    alike). Returns, per path, the list of per-window images/s and the
    median ms per predict."""
    import statistics
    import torch

    def one_window(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            predict(images)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    n = max(min_predicts, int(window_s / (one_window(3) / 3)))
    rates = {"kernels": [], "plain": []}
    for _ in range(windows):
        rates["kernels"].append(len(images) * n / one_window(n))
        with plain_kernels():
            rates["plain"].append(len(images) * n / one_window(n))
    return {path: dict(ips=r, median_ips=statistics.median(r),
                       ms_per_predict=1e3 * len(images)
                       / statistics.median(r), predicts_per_window=n)
            for path, r in rates.items()}


def full_batch_logits(model, images):
    """The model's logits on the whole normalized batch, kernels and plain
    versions: what predict's decode reads."""
    import torch
    from real_time_helmet_detection_tpu_torch.utils import normalizer_stats
    mean, std = (torch.as_tensor(s, device="cuda")
                 for s in normalizer_stats("imagenet"))
    x = (torch.as_tensor(images).cuda().float() / 255.0 - mean) / std
    with torch.inference_mode():
        lk = model(x)
        with plain_kernels():
            lp = model(x)
    return lk, lp


def phase_main(state):
    """The flagship's predict at b16 512^2, f32 and bf16
    (`predict_against_plain`, Detections also matched both ways), its peak
    memory and images/s; then a small model on the card against the CPU
    path."""
    import numpy as np
    import torch
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state
    from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
    images = np.random.default_rng(0).integers(
        0, 256, (16, 512, 512, 3), dtype=np.uint8)
    for amp in (False, True):
        tag = "bf16" if amp else "f32"
        cfg = Config(batch_size=16, imsize=512, amp=amp)
        model, predict, rec = predict_against_plain(
            "main " + tag, cfg, images, seed=3, match_both_ways=True)
        state.setdefault("launches", {})[tag] = rec["counts"]
        # peak memory of one kernel-path predict, then throughput
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        predict(images)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rates = throughput(predict, images, windows=3, window_s=1.0)
        state.setdefault("main", {})[tag] = dict(
            rates=rates, peak_gb=peak_gb, logit_err=rec["logit_err"],
            valid=rec["valid"], checked=rec["checked"])
        log("main %s: launches %s per forward; logits (16 images) kernel vs "
            "plain max abs err %g (tol %g, bit-equal %s), Detections "
            "identical %s; %d detections >= 0.1 matched both ways; %d valid "
            "after NMS; peak memory %.2f GB"
            % (tag, rec["counts"], rec["logit_err"], rec["tol"],
               rec["bit_equal"], rec["identical"], rec["checked"],
               rec["valid"], peak_gb))
        for path, r in rates.items():
            log("main %s: predict b16 512^2 with %s: median %.1f img/s "
                "(%.2f ms per predict), min %.1f, max %.1f over %d windows "
                "of %d predicts: %s" % (
                    tag, path, r["median_ips"], r["ms_per_predict"],
                    min(r["ips"]), max(r["ips"]), len(r["ips"]),
                    r["predicts_per_window"],
                    ", ".join("%.1f" % v for v in r["ips"])))
        del model, predict
        torch.cuda.empty_cache()
    # a small model on the card (kernels) against the CPU path (plain)
    cfg = Config(batch_size=2, imsize=64, hourglass_inch=32, num_stack=2)
    model = perturb_bn(load_eval_state(cfg, device="cpu"), seed=4)
    small = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3),
                                              dtype=np.uint8)
    d_cpu = make_predict_fn(model, cfg, normalize="imagenet",
                            device="cpu")(small)
    d_gpu = make_predict_fn(model, cfg, normalize="imagenet")(small)
    checked = detections_match(d_gpu, d_cpu) + detections_match(d_cpu, d_gpu)
    log("main small: card vs CPU path, %d detections >= 0.1 matched both "
        "ways" % checked)


def phase_states(state):
    """Phase main's kernel-vs-plain comparison under two more BN states
    with larger logits: flax's init (scale 1, mean 0, var 1) and scales
    in [0.5, 1.5]. More heat scores round to 1 there, so ties decide the
    top-k and NMS order, and more raw size regressions come out negative
    (inverted boxes). Holds the rule of phase main and reports whether
    the two paths' logits and Detections are identical."""
    import numpy as np
    import torch
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state
    from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
    images = np.random.default_rng(0).integers(
        0, 256, (16, 512, 512, 3), dtype=np.uint8)
    for label, scale in (("flax init", None), ("scale 0.5-1.5", (0.5, 1.5))):
        for amp in (False, True):
            tag = "bf16" if amp else "f32"
            cfg = Config(batch_size=16, imsize=512, amp=amp)
            model = load_eval_state(cfg)
            if scale is not None:
                perturb_bn(model, seed=3, scale=scale)
            predict = make_predict_fn(model, cfg, normalize="imagenet")
            lk, lp = full_batch_logits(model, images)
            tol = 1e-4 if not amp else 2e-2
            lerr = float((lk - lp).abs().max())
            require(bool(torch.allclose(lk, lp, rtol=tol, atol=tol)),
                    "%s %s logits kernel vs plain: max abs err %g > tol %g"
                    % (label, tag, lerr, tol))
            dets = predict(images)
            with plain_kernels():
                dets_plain = predict(images)
            checked = detections_match(dets, dets_plain) \
                + detections_match(dets_plain, dets)
            shown = dets.valid & (dets.scores >= 0.1)
            b = dets.boxes
            inverted = shown & ((b[..., 2] < b[..., 0])
                                | (b[..., 3] < b[..., 1]))
            log("states %s %s: |logit| max %.2f; heat scores >= 0.99995: "
                "%.4f%%; logits (16 images) kernel vs plain bit-equal %s, "
                "max abs err %g; Detections identical %s; %d detections >= "
                "0.1 matched both ways; %d of the kernel path's %d are "
                "inverted boxes" % (
                    label, tag, float(lk.abs().max()),
                    100 * float((torch.sigmoid(lk[..., :2]) >= 0.99995)
                                .float().mean()),
                    torch.equal(lk, lp), lerr,
                    all(torch.equal(x, y) for x, y in zip(dets, dets_plain)),
                    checked, int(inverted.sum()), int(shown.sum())))
            del model, predict, lk, lp
            torch.cuda.empty_cache()


# ----------------------------------------------------------- train phases


ACTS = ("ReLU", "Linear", "Mish")
TRAIN_SUM_RTOL = 1e-5  # per channel, relative to the sum of |terms|
F32_FLOPS = 67e12      # H100 SXM float32 outside the tensor cores
BIG = (16, 128, 256, 256)  # the largest BN site of the train step


def rows2d(t):
    """(N, C, H, W) channels-last -> (N*H*W, C) float32."""
    return t.float().permute(0, 2, 3, 1).reshape(-1, t.shape[1])


def sums_err(got_parts, want_parts, terms):
    """(max relative, max abs) error between the column sums of two
    partial tensors, relative to the per-channel sum of |terms| — the
    error bound of a float32 sum taken in another order."""
    import torch
    torch.cuda.synchronize()
    d = (got_parts.sum(0) - want_parts.sum(0)).abs()
    scale = terms.abs().sum(0).clamp_min(1e-30)
    return float((d / scale).max()), float(d.max())


def train_operands(shape, dtype, gen, skip):
    x = channels_last(rand(shape, dtype, gen, 2.0))
    g = channels_last(rand(shape, dtype, gen, 1.0))
    s = channels_last(rand(shape, dtype, gen, 1.0)) if skip else None
    import torch
    c = shape[1]
    a = rand((c,), torch.float32, gen, 0.5) + 1.0
    b = rand((c,), torch.float32, gen, 0.5)
    k1 = rand((c,), torch.float32, gen, 0.01)
    k2 = rand((c,), torch.float32, gen, 0.01)
    return x, g, s, a, b, k1, k2


def phase_train_kernels(state):
    """The train kernels against their plain versions at every distinct BN
    site shape of the flagship train step (b16, 512^2), f32 and bf16,
    every activation, with and without the skip: the dx pass bit-equal
    for ReLU/Linear (Mish within rtol 1e-6 f32 / one bf16 ulp), the
    reductions within TRAIN_SUM_RTOL of the sum of |terms|."""
    import torch
    from real_time_helmet_detection_tpu_torch.ops import epilogue, residual
    gen = torch.Generator(device="cuda").manual_seed(2)
    errs = state.setdefault("train_errs", {})
    mish_equal, n = True, 0
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for skip, shapes in ((False, EPI_SHAPES), (True, RES_SHAPES)):
            for shape in shapes:
                x, g, s, a, b, k1, k2 = train_operands(shape, dtype, gen,
                                                       skip)
                xr = rows2d(x)
                if not skip:  # moments take no skip: each shape once
                    got, want = epilogue.bn_stats(x), \
                        epilogue.bn_stats_reference(x)
                    e1 = sums_err(got[0], want[0], xr)
                    e2 = sums_err(got[1], want[1], xr * xr)
                    errs[("bn_stats", tag, shape)] = max(e1, e2)
                    n += 1
                for act in ACTS:
                    dz = rows2d(epilogue._dz_reference(x, a, b, g, act, s))
                    if skip:
                        s1, s2 = residual.bn_add_bwd_sums(x, a, b, s, g, act)
                        dx, ds = residual.bn_add_bwd_dx(x, a, b, s, g, k1,
                                                        k2, act)
                    else:
                        s1, s2 = epilogue.bn_bwd_sums(x, a, b, g, act)
                        dx = epilogue.bn_bwd_dx(x, a, b, g, k1, k2, act)
                        ds = None
                    w1, w2 = epilogue.bn_bwd_sums_reference(x, a, b, g, act,
                                                            skip=s)
                    wdx, wds = epilogue.bn_bwd_dx_reference(x, a, b, g, k1,
                                                            k2, act, skip=s)
                    prefix = "bn_add_bwd" if skip else "bn_bwd"
                    errs[(prefix + "_sums", tag, act, shape)] = max(
                        sums_err(s1, w1, dz), sums_err(s2, w2, dz * xr))
                    mode = ("equal" if act != "Mish" else
                            "rtol1e-6" if tag == "f32" else "bf16ulp")
                    label = "%s_dx %s %s %s" % (prefix, tag, act, shape)
                    e = compare(label, dx, wdx, mode)
                    if skip:
                        e = max(e, compare(label + " ds", ds, wds, mode))
                    if act == "Mish":
                        mish_equal &= torch.equal(dx, wdx) and (
                            ds is None or torch.equal(ds, wds))
                    errs[(prefix + "_dx", tag, act, shape)] = (e, e)
                    n += 2
                    del dz, s1, s2, dx, ds, w1, w2, wdx, wds
                del x, g, s, xr
                torch.cuda.empty_cache()
    reductions = {k: v for k, v in errs.items() if not k[0].endswith("_dx")}
    worst = max(reductions, key=lambda k: reductions[k][0])
    log("train_kernels: %d comparisons against the plain versions passed; "
        "dx/ds bit-equal for ReLU and Linear, Mish bit-equal %s; the "
        "reductions' largest error %.3g of the sum of |terms| (tolerance "
        "%g) at %s, max abs %.3g" % (n, mish_equal, reductions[worst][0],
                                      TRAIN_SUM_RTOL, worst,
                                      reductions[worst][1]))
    require(reductions[worst][0] <= TRAIN_SUM_RTOL,
            "train reductions beyond tolerance at %s: %s"
            % (worst, reductions[worst]))
    require(all(v[0] == 0.0 for k, v in errs.items()
                if k[0].endswith("_dx") and k[2] != "Mish"),
            "a bit-equal dx comparison reported a non-zero error")


def phase_train_timing(state):
    """Train kernel time at the largest site (16, 128, 256^2), ReLU, by
    CUDA graph replay, beside its bound, the plain version and a library
    call where one computes the same function: `torch.var_mean` for the
    moments, and ATen's BN backward for the Linear no-skip sums + dx
    pair."""
    import torch
    from real_time_helmet_detection_tpu_torch.ops import epilogue, residual
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = state.setdefault("train_timing", {})
    log("train_timing (ms per call at %s; kernel and plain by CUDA graph "
        "replay, eager = issued from Python):" % (BIG,))
    for dtype in (torch.bfloat16, torch.float32):
        tag = "f32" if dtype == torch.float32 else "bf16"
        x, g, s, a, b, k1, k2 = train_operands(BIG, dtype, gen, True)
        nbytes, elems = x.numel() * x.element_size(), x.numel()
        act = "ReLU"
        # name: (kernel, plain, activation-sized tensors moved, flops per
        # element, library call)
        specs = {
            "bn_stats": (lambda: epilogue.bn_stats(x),
                         lambda: epilogue.bn_stats_reference(x), 1, 3,
                         lambda: torch.var_mean(x, dim=(0, 2, 3),
                                                correction=0)),
            "bn_bwd_sums": (
                lambda: epilogue.bn_bwd_sums(x, a, b, g, act),
                lambda: epilogue.bn_bwd_sums_reference(x, a, b, g, act),
                2, 6, None),
            "bn_add_bwd_sums": (
                lambda: residual.bn_add_bwd_sums(x, a, b, s, g, act),
                lambda: residual.bn_add_bwd_sums_reference(x, a, b, s, g,
                                                           act), 3, 7, None),
            "bn_bwd_dx": (
                lambda: epilogue.bn_bwd_dx(x, a, b, g, k1, k2, act),
                lambda: epilogue.bn_bwd_dx_reference(x, a, b, g, k1, k2,
                                                     act), 3, 7, None),
            "bn_add_bwd_dx": (
                lambda: residual.bn_add_bwd_dx(x, a, b, s, g, k1, k2, act),
                lambda: residual.bn_add_bwd_dx_reference(x, a, b, s, g, k1,
                                                         k2, act), 5, 8,
                None),
        }
        for name, (kern, plain, ntens, flops, lib) in specs.items():
            t_bytes = ntens * nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops * elems / F32_FLOPS * 1e3
            rows[(name, tag)] = dict(
                ms=graph_ms(kern), eager_ms=eager_ms(kern),
                plain_ms=graph_ms(plain),
                library_ms=None if lib is None else graph_ms(lib),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                shape=BIG)
        mean = torch.zeros(BIG[1], device="cuda")
        invstd = torch.ones(BIG[1], device="cuda")
        rows[("bwd_pair_linear", tag)] = dict(
            ms=graph_ms(lambda: (
                epilogue.bn_bwd_sums(x, a, b, g, "Linear"),
                epilogue.bn_bwd_dx(x, a, b, g, k1, k2, "Linear"))),
            library_ms=graph_ms(
                lambda: torch.ops.aten.native_batch_norm_backward(
                    g, x, a, None, None, mean, invstd, True, 1e-5,
                    [True, True, True])),
            bound_ms=4 * nbytes / HBM_BYTES_PER_S * 1e3)
        del x, g, s
        torch.cuda.empty_cache()
    for key, r in rows.items():
        if key[0] == "bwd_pair_linear":
            log("  %-24s kernels %.4f  native_batch_norm_backward %.4f  "
                "bound %.4f" % ("%s %s" % key, r["ms"], r["library_ms"],
                                r["bound_ms"]))
            continue
        log("  %-24s kernel %.4f (eager %.4f)  plain %.4f  library %s  "
            "bound %.4f (%s)" % (
                "%s %s" % key, r["ms"], r["eager_ms"], r["plain_ms"],
                "%.4f" % r["library_ms"] if r["library_ms"] is not None
                else "none", r["bound_ms"], r["bound_by"]))


# ------------------------------------------------------------ loss phases


LOSS_SHAPE = (16, 1, 128, 128, 6)  # the flagship's raw output at b16 512^2
LOSS_SUM_RTOL = 1e-5  # per (stack, sample), relative to the sum of |terms|
# (label, options, logit scale): the defaults, the coordinate sigmoid,
# non-default focal exponents, a batch with no positives, logits x20
# whose sigmoids round to 1, a mask of fractions and zeros (a guard for
# any later branch on the mask's value), and NaN and +-inf among the
# logits (both with the coordinate sigmoid too)
LOSS_CASES = (
    ("default", dict(alpha=2.0, beta=4.0, normalized=False), 2.0),
    ("normalized", dict(alpha=2.0, beta=4.0, normalized=True), 2.0),
    ("alpha3beta3", dict(alpha=3.0, beta=3.0, normalized=False), 2.0),
    ("no positives", dict(alpha=2.0, beta=4.0, normalized=False), 2.0),
    ("saturated", dict(alpha=2.0, beta=4.0, normalized=False), 40.0),
    ("non-binary mask", dict(alpha=2.0, beta=4.0, normalized=False), 2.0),
    ("non-binary mask normalized", dict(alpha=2.0, beta=4.0,
                                        normalized=True), 2.0),
    ("nan-inf", dict(alpha=2.0, beta=4.0, normalized=False), 2.0),
    ("nan-inf normalized", dict(alpha=2.0, beta=4.0, normalized=True), 2.0))
# operations per element of the kernels' arithmetic (a transcendental
# counts as one): forward 20 per heat channel, 5 per regression channel;
# backward 31 and 6
LOSS_OPS = {"loss_fwd": (20, 5), "loss_bwd": (31, 6)}
# the backward off the flagship's shape, (shape, variant, misaligned): two
# stacks and a ragged last tile (vector), H*W % 4 != 0 and out one element
# into its storage (scalar); NaN and +-inf in 1% of the logits each time
LOSS_OTHER = [((3, 2, 36, 44, 6), "vector", False),
              ((3, 2, 37, 45, 6), "scalar", False),
              ((3, 2, 36, 44, 6), "scalar", True)]
LOSS_KERNELS = {"loss_fwd": "loss_fwd_kernel",  # the kernels' names
                "loss_bwd": "loss_bwd_vec_kernel"}


def loss_sum_errs(got, want, terms):
    """(max relative, max abs) error between two sets of the four (S, B)
    sums, relative to each (stack, sample)'s sum of |terms|, over the sums
    finite in both; NaN if one set is finite or NaN where the other is
    not."""
    import torch
    torch.cuda.synchronize()
    rel = ab = 0.0
    for g, w, t in zip(got, want, terms):
        if not (torch.equal(torch.isfinite(g), torch.isfinite(w))
                and nan_equal(torch.where(torch.isfinite(g), 0.0, g),
                              torch.where(torch.isfinite(w), 0.0, w))):
            return float("nan"), float("nan")
        fin = torch.isfinite(g)
        scale = t.abs().sum(dim=(2, 3, 4)).t().clamp_min(1e-30)
        d = (g - w).abs()[fin]
        if d.numel():
            rel = max(rel, float((d / scale[fin]).max()))
            ab = max(ab, float(d.max()))
    return rel, ab


def phase_loss_kernels(state):
    """The loss kernels against their plain versions at the flagship's
    output shape on synthetic_target_batch's targets, every LOSS_CASES
    case, f32 and bf16 logits: the sums within LOSS_SUM_RTOL of the sum
    of |terms| per (stack, sample) (NaN where the plain version's is),
    d(out) bit-equal (NaN where the plain version's is) from the
    backward's vector kernel."""
    import torch
    from real_time_helmet_detection_tpu_torch.ops import loss
    gen = torch.Generator(device="cuda").manual_seed(4)
    heat, off, wh, mask = train_batch()[1:]
    errs = state.setdefault("loss_errs", {})
    fractions = torch.rand(mask.shape, generator=gen, device="cuda") \
        * (torch.rand(mask.shape, generator=gen, device="cuda") < 0.3)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for label, kw, scale in LOSS_CASES:
            m = torch.zeros_like(mask) if label == "no positives" \
                else fractions if label.startswith("non-binary") else mask
            o = rand(LOSS_SHAPE, dtype, gen, scale)
            if label.startswith("nan-inf"):
                o = nonfinite(o, gen)
            ops = (o, heat, off, wh, m)
            got = loss.loss_sums(*ops, **kw)
            want = loss.loss_sums_reference(*ops, **kw)
            rel, ab = loss_sum_errs(got, want, loss.loss_terms_reference(
                *ops, **kw))
            cots = [rand(LOSS_SHAPE[1::-1], torch.float32, gen)
                    for _ in range(4)]
            before = loss.bwd_vector_launches
            dg = loss.loss_sums_bwd(*ops, *cots, **kw)
            require(loss.bwd_vector_launches == before + 1,
                    "loss %s %s: the backward did not take its vector "
                    "kernel" % (tag, label))
            dw = loss.loss_sums_bwd_reference(*ops, *cots, **kw)
            torch.cuda.synchronize()
            name = "loss %s %s" % (tag, label)
            require(dg.shape == dw.shape and dg.dtype == dw.dtype == dtype,
                    "%s: d(out) %s %s vs %s %s" % (name, tuple(dg.shape),
                                                   dg.dtype, tuple(dw.shape),
                                                   dw.dtype))
            if not label.startswith("nan-inf"):
                require(all(bool(torch.isfinite(t).all())
                            for t in (*got, dg)),
                        "%s: non-finite kernel output" % name)
            errs[(label, tag)] = dict(
                sum_rel=rel, sum_abs=ab,
                dout_abs=compare(name + " d(out)", dg, dw,
                                 "nan_equal" if label.startswith("nan-inf")
                                 else "equal"),
                sums_equal=all(
                    nan_equal(a, b) for a, b in zip(got, want)))
            require(rel <= LOSS_SUM_RTOL, "%s: sums off by %g of the sum of "
                    "|terms| (tolerance %g)" % (name, rel, LOSS_SUM_RTOL))
    kw = dict(alpha=2.0, beta=4.0, normalized=False)
    for shape, variant, offset in LOSS_OTHER:
        b, s, h, w, k = shape

        def target(c, scale=1.0):
            return torch.rand((b, h, w, c), generator=gen,
                              device="cuda") * scale
        targets = (target(k - 4), target(2), target(2, 20.0),
                   (target(1) < 0.05).float())
        for dtype in (torch.float32, torch.bfloat16):
            o = nonfinite(rand((math.prod(shape) + offset,), dtype, gen,
                               2.0), gen, 0.01)[offset:].view(shape)
            cots = [rand((s, b), torch.float32, gen) for _ in range(4)]
            before = (loss.bwd_vector_launches, loss.bwd_scalar_launches)
            dg = loss.loss_sums_bwd(o, *targets, *cots, **kw)
            took = "vector" if loss.bwd_vector_launches > before[0] \
                else "scalar" if loss.bwd_scalar_launches > before[1] \
                else None
            name = "loss_sums_bwd %s %s%s" % (dtype, shape,
                                             " misaligned" * offset)
            require(took == variant, "%s ran the %s kernel, want %s"
                    % (name, took, variant))
            compare(name, dg, loss.loss_sums_bwd_reference(
                o, *targets, *cots, **kw), "nan_equal")
    worst = max(errs, key=lambda k: errs[k]["sum_rel"])
    log("loss_kernels: %d cases against the plain versions passed; sums' "
        "largest error %.3g of the sum of |terms| (tolerance %g) at %s, "
        "bit-equal in %d of %d cases; d(out) bit-equal in all %d cases "
        "(NaN-aware), from the backward's vector kernel; and at %s"
        % (len(errs), errs[worst]["sum_rel"], LOSS_SUM_RTOL, worst,
           sum(e["sums_equal"] for e in errs.values()), len(errs),
           len(errs), ", ".join("%s on its %s kernel%s" % (
               sh, v, " (misaligned)" * o) for sh, v, o in LOSS_OTHER)))


def phase_loss_timing(state):
    """The loss kernels at the flagship's f32 output (the train step's
    dtype) by CUDA graph replay, beside their bounds and plain versions;
    no single PyTorch call computes the loss, so the library column is
    empty and the eager composition's forward + backward
    (`stacked_detection_loss`) and the fused loss's stand beside. Each
    wrapper's calls under torch.profiler give its kernel's own device
    time and the number of device operations per call (1: `loss_sums`
    folds its tiles inside the launch)."""
    import torch
    from real_time_helmet_detection_tpu_torch.ops import loss
    gen = torch.Generator(device="cuda").manual_seed(6)
    heat, off, wh, mask = train_batch()[1:]
    out = rand(LOSS_SHAPE, torch.float32, gen, 2.0)
    ops = (out, heat, off, wh, mask)
    kw = dict(alpha=2.0, beta=4.0, normalized=False)
    cots = [rand(LOSS_SHAPE[1::-1], torch.float32, gen) for _ in range(4)]

    def path(fn):
        def run():
            o = out.detach().requires_grad_(True)
            fn(o, *ops[1:])["total"].backward()
        return run

    composition = eager_ms(path(lambda *a: loss.stacked_detection_loss(
        *a, num_cls=LOSS_SHAPE[-1] - 4)))
    fused = eager_ms(path(loss.fused_detection_loss))
    targets = sum(t.numel() * t.element_size() for t in ops[1:])
    nout = out.numel() * out.element_size()
    heat_elems = heat.numel() * LOSS_SHAPE[1]
    reg_elems = out.numel() - heat_elems
    rows = state.setdefault("loss_timing", {})
    reps = 20  # calls under the profiler
    for name, kern, plain, nbytes in (
            ("loss_fwd", lambda: loss.loss_sums(*ops, **kw),
             lambda: loss.loss_sums_reference(*ops, **kw), nout + targets),
            ("loss_bwd", lambda: loss.loss_sums_bwd(*ops, *cots, **kw),
             lambda: loss.loss_sums_bwd_reference(*ops, *cots, **kw),
             2 * nout + targets)):
        per_heat, per_reg = LOSS_OPS[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = (per_heat * heat_elems + per_reg * reg_elems) \
            / F32_FLOPS * 1e3
        ops_seen = {}
        by_name, _ = trace_device_ms(lambda i: kern(), reps, ops_seen)
        kernel = LOSS_KERNELS[name]
        rows[name] = dict(
            ms=graph_ms(kern), eager_ms=eager_ms(kern),
            plain_ms=graph_ms(plain), library_ms=None,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            kernel_device_ms=sum(v for k, v in by_name.items()
                                 if kernel in k),
            device_ops_per_call=sum(ops_seen.values()) or None,
            other_device_ops=sorted(k for k in ops_seen if kernel not in k),
            composition_ms=composition, fused_ms=fused, shape=LOSS_SHAPE)
    # the backward's scalar kernel, for the shapes the vector one cannot
    # take, at the same inputs
    rows["loss_bwd"]["scalar_ms"] = graph_ms(lambda: loss.loss_sums_bwd(
        *ops, *cots, **kw, variant="scalar"))
    # the profiler may drop an event, so the count per call may read a
    # little under 1; any device operation but the kernel is a failure
    for name, wrapper in (("loss_fwd", "loss_sums"),
                          ("loss_bwd", "loss_sums_bwd")):
        r = rows[name]
        require(not r["other_device_ops"]
                and (r["device_ops_per_call"] or 0) <= 1,
                "%s ran device operations besides its kernel: %s, %s per "
                "call" % (wrapper, r["other_device_ops"],
                          r["device_ops_per_call"]))
    log("loss_timing (ms per call at %s f32; kernel and plain by CUDA "
        "graph replay, eager = issued from Python, device = the kernel's "
        "own time under torch.profiler):" % (LOSS_SHAPE,))
    for name, r in rows.items():
        log("  %-9s kernel %.4f (eager %.4f, device %.4f, %s device "
            "operations per call)%s  plain %.4f  library none  bound %.4f "
            "(%s, %.0f%% of it)" % (
                name, r["ms"], r["eager_ms"], r["kernel_device_ms"],
                r["device_ops_per_call"],
                "  scalar kernel %.4f" % r["scalar_ms"]
                if "scalar_ms" in r else "", r["plain_ms"], r["bound_ms"],
                r["bound_by"], 100 * r["bound_ms"] / r["ms"]))
    log("  forward + backward issued from Python: the fused loss %.4f, the "
        "composition stacked_detection_loss %.4f" % (fused, composition))


# ------------------------------------------------------- eval-grad phases


def phase_eval_grad(state):
    """The eval-mode BN backward kernels against their plain versions at
    every BN site shape, f32 and bf16, every activation (dx/ds as the
    train dx pass, partials within TRAIN_SUM_RTOL of the sum of |terms|);
    then the flagship model in eval mode at b16 512^2 (seeded weights,
    a random BN state), the fused loss on synthetic_target_batch and
    backward(), f32 and bf16, through the kernels and through the plain
    versions under cudnn.deterministic."""
    import torch
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.ops import epilogue, residual
    gen = torch.Generator(device="cuda").manual_seed(5)
    errs = state.setdefault("eval_errs", {})
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for skip, shapes in ((False, EPI_SHAPES), (True, RES_SHAPES)):
            name = "bn_add_eval_bwd" if skip else "bn_eval_bwd"
            for shape in shapes:
                x, g, s, a, b, _, _ = train_operands(shape, dtype, gen, skip)
                xr = rows2d(x)
                for act in ACTS:
                    dz = rows2d(epilogue._dz_reference(x, a, b, g, act, s))
                    if skip:
                        dx, ds, da, db = residual.bn_add_eval_bwd(
                            x, a, b, s, g, act)
                        wdx, wds, wda, wdb = \
                            residual.bn_add_eval_bwd_reference(x, a, b, s,
                                                               g, act)
                    else:
                        dx, da, db = epilogue.bn_eval_bwd(x, a, b, g, act)
                        wdx, wda, wdb = epilogue.bn_eval_bwd_reference(
                            x, a, b, g, act)
                        ds = wds = None
                    mode = ("equal" if act != "Mish" else
                            "rtol1e-6" if tag == "f32" else "bf16ulp")
                    label = "%s %s %s %s" % (name, tag, act, shape)
                    e = compare(label, dx, wdx, mode)
                    if skip:
                        e = max(e, compare(label + " ds", ds, wds, mode))
                    errs[(name, tag, act, shape)] = dict(
                        sums=max(sums_err(da, wda, dz * xr),
                                 sums_err(db, wdb, dz)), dx=e)
                    n += 1
                    del dz, dx, ds, da, db, wdx, wds, wda, wdb
                del x, g, s, xr
                torch.cuda.empty_cache()
    worst = max(errs, key=lambda k: errs[k]["sums"][0])
    log("eval_grad kernels: %d comparisons against the plain versions "
        "passed; dx/ds bit-equal for ReLU and Linear (Mish max abs err "
        "%.3g); the partials' largest error %.3g of the sum of |terms| "
        "(tolerance %g) at %s, max abs %.3g" % (
            n, max(v["dx"] for v in errs.values()),
            errs[worst]["sums"][0], TRAIN_SUM_RTOL, worst,
            errs[worst]["sums"][1]))
    require(errs[worst]["sums"][0] <= TRAIN_SUM_RTOL,
            "eval backward partials beyond tolerance at %s" % (worst,))
    require(all(v["dx"] == 0.0 for k, v in errs.items() if k[2] != "Mish"),
            "a bit-equal eval dx comparison reported a non-zero error")

    arrs = train_batch()
    runs = {}
    for amp in (False, True):
        tag = "bf16" if amp else "f32"
        runs[tag] = eval_grad_against_plain(
            "eval_grad " + tag, Config(batch_size=16, imsize=512, amp=amp),
            arrs)
        state.setdefault("launches", {})["eval_grad_" + tag] = \
            runs[tag]["counts"]
    f32, b16 = runs["f32"], runs["bf16"]
    e = dict(f32_loss=f32["loss_err"], f32_grad=f32["grad_err"],
             bf16_loss=b16["loss_err"],
             bf16_grad_vs_f32=(rel_l2(b16["grads"], f32["plain_grads"]),
                               rel_l2(b16["plain_grads"],
                                      f32["plain_grads"])))
    state["eval_grad"] = dict(errs=e, params=f32["params"])
    log("eval_grad model (b16 512^2, eval mode, fused loss, backward): "
        "bf16 loss %.6f vs %.6f, gradient rel L2 to the f32 plain path: "
        "kernels %.3g, plain %.3g (kernels at most 1.5x plain)" % (
            b16["loss"], b16["plain_loss"], *e["bf16_grad_vs_f32"]))
    require(e["f32_grad"] <= 1e-5 and e["f32_loss"] <= 1e-5,
            "f32 eval gradient kernels vs plain beyond tolerance: %s" % e)
    require(e["bf16_grad_vs_f32"][0] <= 1.5 * e["bf16_grad_vs_f32"][1],
            "bf16 eval gradient further from the f32 plain path than 1.5x "
            "the bf16 plain path: %s" % (e["bf16_grad_vs_f32"],))


def phase_eval_timing(state):
    """The eval backward kernels at the largest site (16, 128, 256^2),
    ReLU, bf16 and f32, by CUDA graph replay, beside their bounds and
    plain versions; ATen's BN backward in eval mode (weight a, running
    mean 0, var 1, eps 0; its CUDA version asserts the saved statistics
    are given, though eval mode reads the running ones) computes the
    Linear no-skip pass in one call."""
    import torch
    from real_time_helmet_detection_tpu_torch.ops import epilogue, residual
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = state.setdefault("eval_timing", {})
    for dtype in (torch.bfloat16, torch.float32):
        tag = "f32" if dtype == torch.float32 else "bf16"
        x, g, s, a, b, _, _ = train_operands(BIG, dtype, gen, True)
        nbytes, elems = x.numel() * x.element_size(), x.numel()
        zeros, ones = torch.zeros_like(a), torch.ones_like(a)
        for name, kern, plain, ntens, flops in (
                ("bn_eval_bwd",
                 lambda: epilogue.bn_eval_bwd(x, a, b, g, "ReLU"),
                 lambda: epilogue.bn_eval_bwd_reference(x, a, b, g, "ReLU"),
                 3, 8),
                ("bn_add_eval_bwd",
                 lambda: residual.bn_add_eval_bwd(x, a, b, s, g, "ReLU"),
                 lambda: residual.bn_add_eval_bwd_reference(x, a, b, s, g,
                                                            "ReLU"), 5, 9)):
            t_bytes = ntens * nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops * elems / F32_FLOPS * 1e3
            rows[(name, tag)] = dict(
                ms=graph_ms(kern), eager_ms=eager_ms(kern),
                plain_ms=graph_ms(plain), library_ms=None,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                shape=BIG)
        rows[("bn_eval_bwd_linear", tag)] = dict(
            ms=graph_ms(lambda: epilogue.bn_eval_bwd(x, a, b, g, "Linear")),
            library_ms=graph_ms(
                lambda: torch.ops.aten.native_batch_norm_backward(
                    g, x, a, zeros, ones, zeros, ones, False, 0.0,
                    [True, True, True])),
            bound_ms=3 * nbytes / HBM_BYTES_PER_S * 1e3)
        del x, g, s
        torch.cuda.empty_cache()
    log("eval_timing (ms per call at %s; kernel and plain by CUDA graph "
        "replay, eager = issued from Python):" % (BIG,))
    for key, r in rows.items():
        if key[0] == "bn_eval_bwd_linear":
            log("  %-24s kernel %.4f  native_batch_norm_backward (eval) "
                "%.4f  bound %.4f" % ("%s %s" % key, r["ms"], r["library_ms"],
                                      r["bound_ms"]))
            continue
        log("  %-24s kernel %.4f (eager %.4f)  plain %.4f  library none  "
            "bound %.4f (%s)" % ("%s %s" % key, r["ms"], r["eager_ms"],
                                 r["plain_ms"], r["bound_ms"], r["bound_by"]))


def extras_trainer(cfg, seed=0, monitor=None, **kw):
    """cfg's model with seeded weights on the card in train mode, its
    optimizer (`init_train_state`: the bf16 policy's masters, the EMA)
    and the port's train step with `kw` (a distiller); under
    `cfg.sentinel` with a `Sentinel` (as `step.sentinel`) and the loss
    scale of `monitor`."""
    import torch
    from real_time_helmet_detection_tpu_torch.evaluate import init_weights
    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        build_model
    from real_time_helmet_detection_tpu_torch.optim import make_lr_schedule
    from real_time_helmet_detection_tpu_torch.train import (
        Sentinel, init_train_state, make_train_step)
    dtype = torch.bfloat16 if cfg.amp else None
    model = init_weights(build_model(cfg, dtype=dtype), seed)
    opt, ema = init_train_state(cfg, model, "cuda")
    sentinel = Sentinel(cfg, model, opt, ema, "cuda") if cfg.sentinel \
        else None
    step = make_train_step(
        model, opt, make_lr_schedule(cfg, 1000), cfg, ema=ema,
        sentinel=sentinel,
        loss_scale=monitor.scale_value if monitor else None, **kw)
    step.sentinel = sentinel
    return model, opt, ema, step


def train_batch(batch=16, imsize=512):
    import torch
    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        synthetic_target_batch
    return [torch.from_numpy(a).cuda()
            for a in synthetic_target_batch(batch, imsize, seed=0)]


def one_backward(model, arrs, cfg):
    """(loss, grads, buffers) of one loss + backward, no update."""
    import torch
    from real_time_helmet_detection_tpu_torch.train import loss_fn
    model.zero_grad(set_to_none=True)
    total, _ = loss_fn(model, *arrs, cfg)
    total.backward()
    torch.cuda.synchronize()
    return (total.item(),
            {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            {n: t.detach().clone() for n, t in model.named_buffers()})


def exact_sums():
    """Inside plain_kernels(): every BN channel sum of the train step
    (moments, S1, S2) taken in float64 and rounded once to float32 — the
    step whose only difference from the kernel and plain paths is that
    neither's f32 summation order touches it."""
    from real_time_helmet_detection_tpu_torch.ops import epilogue, residual

    def stats(x):
        x2 = rows2d(x).double()
        return (x2.sum(0, keepdim=True).float(),
                (x2 * x2).sum(0, keepdim=True).float())

    def sums(x, a, b, g, act, skip=None):
        dz = rows2d(epilogue._dz_reference(x, a, b, g, act, skip)).double()
        return (dz.sum(0, keepdim=True).float(),
                (dz * rows2d(x).double()).sum(0, keepdim=True).float())

    return swapped([
        (epilogue, "bn_stats", stats), (epilogue, "bn_bwd_sums", sums),
        (residual, "bn_add_bwd_sums",
         lambda y, a, b, skip, g, act: sums(y, a, b, g, act, skip))])


def kernels_and_plain(model, arrs, cfg, exact=False):
    """One loss + backward through the kernels and one through the plain
    versions (and, with `exact`, one through the plain versions with
    float64 sums), from the same weights and running statistics, under
    cudnn.deterministic; the model's buffers are restored after."""
    import torch
    buffers = {n: t.detach().clone() for n, t in model.named_buffers()}
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        runs.append(one_backward(model, arrs, cfg))
        model.load_state_dict(buffers, strict=False)
        with plain_kernels():
            runs.append(one_backward(model, arrs, cfg))
            if exact:
                model.load_state_dict(buffers, strict=False)
                with exact_sums():
                    runs.append(one_backward(model, arrs, cfg))
    finally:
        torch.backends.cudnn.deterministic = False
        model.load_state_dict(buffers, strict=False)
        model.zero_grad(set_to_none=True)
    return runs


def rel_l2(a, b):
    """||a - b|| / ||b|| over every tensor of two name -> tensor dicts
    taken as one vector (a per-tensor measure would be dominated by
    tensors whose gradient is zero by construction, the biases of the
    convs that feed a BN)."""
    num = sum(float((a[n].double() - b[n].double()).square().sum())
              for n in b)
    den = sum(float(b[n].double().square().sum()) for n in b)
    return math.sqrt(num / max(den, 1e-300))


# kernel-vs-plain train step. f32 (TF32 off): the kernels and the plain
# versions differ only in the order of the BN sums; the loss and the
# running statistics agree closely (relative error, relative L2), and
# the gradient within the JAX package's own bound for two BN
# formulations, rtol 5e-3 (tests/test_epilogue.py:151-154): each BN
# backward passes the last-bit differences of its sums on, and the stem
# gradients carry those of all 37. The yardstick for that is the step
# with float64 BN sums (`exact_sums`): the kernel path's f32 gradient and
# statistics are no further from it than 1.5x the plain path's. bf16:
# every BN output rounds to bf16, and a last-bit change in a batch
# moment flips the rounding of some elements; the yardstick is the f32
# plain step: the kernel path's bf16 gradient and statistics are no
# further from it than 1.5x the plain path's bf16 ones.
STEP_TOL = dict(f32_loss=1e-5, f32_grad=5e-3, f32_stats=1e-5,
                f32_ratio=1.5, bf16_loss=1e-3, bf16_ratio=1.5)


def check_train_step(model, model32, arrs, cfg, cfg32):
    """The bf16 (--amp) and f32 train steps, kernels against plain
    versions, held to STEP_TOL; returns the measured errors."""
    (lk, gk, bk), (lp, gp, bp) = kernels_and_plain(model, arrs, cfg)
    (lk32, gk32, bk32), (lp32, gp32, bp32), (_, gx32, bx32) = \
        kernels_and_plain(model32, arrs, cfg32, exact=True)
    e = dict(
        f32_loss=abs(lk32 - lp32) / abs(lp32), f32_grad=rel_l2(gk32, gp32),
        f32_stats=rel_l2(bk32, bp32),
        f32_grad_vs_exact=(rel_l2(gk32, gx32), rel_l2(gp32, gx32)),
        f32_stats_vs_exact=(rel_l2(bk32, bx32), rel_l2(bp32, bx32)),
        bf16_loss=abs(lk - lp) / abs(lp),
        bf16_grad=rel_l2(gk, gp), bf16_stats=rel_l2(bk, bp),
        bf16_grad_vs_f32=(rel_l2(gk, gp32), rel_l2(gp, gp32)),
        bf16_stats_vs_f32=(rel_l2(bk, bp32), rel_l2(bp, bp32)))
    log("train step kernels vs plain (cudnn.deterministic): f32 loss "
        "%.7f vs %.7f, rel err %.3g (tol %g), gradient rel L2 %.3g (tol "
        "%g), running statistics rel L2 %.3g (tol %g); against the step "
        "with float64 BN sums: gradient kernels %.3g, plain %.3g, running "
        "statistics kernels %.3g, plain %.3g (kernels at most %gx plain)"
        % (lk32, lp32, e["f32_loss"], STEP_TOL["f32_loss"], e["f32_grad"],
           STEP_TOL["f32_grad"], e["f32_stats"], STEP_TOL["f32_stats"],
           *e["f32_grad_vs_exact"], *e["f32_stats_vs_exact"],
           STEP_TOL["f32_ratio"]))
    log("train step kernels vs plain: bf16 loss %.6f vs %.6f, rel err %.3g "
        "(tol %g); gradient rel L2 kernels vs plain %.3g; against the f32 "
        "plain step: gradient kernels %.3g, plain %.3g, running statistics "
        "kernels %.3g, plain %.3g (kernels at most %gx plain)" % (
            lk, lp, e["bf16_loss"], STEP_TOL["bf16_loss"], e["bf16_grad"],
            *e["bf16_grad_vs_f32"], *e["bf16_stats_vs_f32"],
            STEP_TOL["bf16_ratio"]))
    for tag, (g_a, g_b) in (("f32", (gk32, gp32)), ("bf16", (gk, gp))):
        den = sum(float(t.double().square().sum()) for t in g_b.values())
        share = sorted(((float((g_a[n].double() - g_b[n].double()).square()
                               .sum()) / den, n) for n in g_b), reverse=True)
        log("    %s gradient difference, largest shares of the squared "
            "relative L2 error %.3g: %s" % (
                tag, sum(v for v, _ in share), ", ".join(
                    "%s %.3g (|g| max %.3g)" % (n, v, float(
                        g_b[n].abs().max())) for v, n in share[:5])))
    require(e["f32_loss"] <= STEP_TOL["f32_loss"]
            and e["f32_grad"] <= STEP_TOL["f32_grad"]
            and e["f32_stats"] <= STEP_TOL["f32_stats"],
            "f32 train step kernels vs plain beyond tolerance")
    ratio = STEP_TOL["f32_ratio"]
    require(e["f32_grad_vs_exact"][0] <= ratio * e["f32_grad_vs_exact"][1]
            and e["f32_stats_vs_exact"][0]
            <= ratio * e["f32_stats_vs_exact"][1],
            "f32 train step kernels further from the float64-sum step "
            "than the plain versions")
    ratio = STEP_TOL["bf16_ratio"]
    require(e["bf16_loss"] <= STEP_TOL["bf16_loss"]
            and e["bf16_grad_vs_f32"][0] <= ratio * e["bf16_grad_vs_f32"][1]
            and e["bf16_stats_vs_f32"][0]
            <= ratio * e["bf16_stats_vs_f32"][1],
            "bf16 train step kernels further from the f32 step than the "
            "plain versions")
    return e


def alternating_rates(steps, arrs, windows=3, window_s=1.0):
    """Train images/s of each named step function in `windows`
    alternating windows of about `window_s` s each."""
    import statistics
    import torch
    counts = {name: 0 for name in steps}

    def one_window(name, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            steps[name](counts[name], *arrs)
            counts[name] += 1
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    sizes = {name: max(5, int(window_s / (one_window(name, 3) / 3)))
             for name in steps}
    rates = {name: [] for name in steps}
    batch = arrs[0].shape[0]
    for _ in range(windows):
        for name in steps:
            rates[name].append(batch * sizes[name]
                               / one_window(name, sizes[name]))
    return {name: dict(ips=r, median_ips=statistics.median(r),
                       ms_per_step=1e3 * batch / statistics.median(r),
                       steps_per_window=sizes[name])
            for name, r in rates.items()}


def train_throughput(step, arrs, windows=5, window_s=2.0):
    """Train images/s of the kernel path and the plain-version path in
    `windows` alternating windows of about `window_s` s each."""
    def plain(count, *a):
        with plain_kernels():
            return step(count, *a)
    return alternating_rates({"kernels": step, "plain": plain}, arrs,
                             windows, window_s)


def phase_train_main(state):
    """The flagship `--amp` train step at b16 512^2 (1 stack, 128
    channels, seeded weights, the port's synthetic_target_batch): launch
    counts of one step, the step against its plain-version twin, the loss
    over 20 steps on one batch, images/s, peak memory; then one f32 step
    (TF32 off)."""
    import statistics
    import torch
    from real_time_helmet_detection_tpu_torch.config import Config
    cfg = Config(batch_size=16, amp=True)
    model, opt, _, step = extras_trainer(cfg)
    arrs = train_batch()
    # warm-up on a throwaway copy of the weights: cuDNN plans, allocator
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    saved_opt = opt.state_dict()
    step(0, *arrs)
    torch.cuda.synchronize()
    model.load_state_dict(saved)
    opt.load_state_dict(saved_opt)
    cfg32 = Config(batch_size=16)
    model32, opt32, _, step32 = extras_trainer(cfg32)
    model32.load_state_dict(model.state_dict())
    errs = check_train_step(model, model32, arrs, cfg, cfg32)
    reset_counts()
    step(0, *arrs)  # THE train-path run the counts read
    torch.cuda.synchronize()
    counts = read_counts()
    from real_time_helmet_detection_tpu_torch.ops import epilogue
    conversions = epilogue.grad_conversions
    want = expected_launches(Config(batch_size=16, imsize=512, amp=True),
                             "train", torch.bfloat16)
    require(counts == want, "launches per train step %s, want %s"
            % (counts, want))
    state.setdefault("launches", {})["train"] = counts
    losses = [float(step(i + 1, *arrs)["total"]) for i in range(20)]
    require(all(map(math.isfinite, losses))
            and statistics.mean(losses[-5:]) < statistics.mean(losses[:5])
            and losses[-1] < losses[0],
            "loss does not fall over 20 steps on one batch: %s" % losses)
    snapshot_check(state, model, cfg, arrs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(21, *arrs)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rates = train_throughput(step, arrs, windows=3, window_s=1.0)
    state["train_main"] = dict(rates=rates, peak_gb=peak_gb, errs=errs,
                               losses=losses, conversions=conversions)
    log("train_main bf16: launches %s per step; %d gradients converted "
        "to channels-last; loss over 20 steps on one batch %.4f -> %.4f "
        "(%s); peak memory %.2f GB" % (
            counts, conversions, losses[0], losses[-1],
            " ".join("%.3f" % v for v in losses), peak_gb))
    for path, r in rates.items():
        log("train_main bf16: train step b16 512^2 with %s: median %.1f "
            "img/s (%.2f ms per step), min %.1f, max %.1f over %d windows "
            "of %d steps: %s" % (
                path, r["median_ips"], r["ms_per_step"], min(r["ips"]),
                max(r["ips"]), len(r["ips"]), r["steps_per_window"],
                ", ".join("%.1f" % v for v in r["ips"])))
    del model, opt, step
    torch.cuda.empty_cache()
    # one f32 step (TF32 off, set process-wide by main())
    model, opt, step = model32, opt32, step32
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(i, *arrs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    step(3, *arrs)
    torch.cuda.synchronize()
    state["train_main"]["f32"] = dict(
        ms_per_step=1e3 * statistics.median(times),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("train_main f32: %.2f ms per step (median of 3, the first "
        "included), %.1f img/s, peak memory %.2f GB" % (
            1e3 * statistics.median(times), 16 / statistics.median(times),
            state["train_main"]["f32"]["peak_gb"]))
    del model, opt, step, arrs
    torch.cuda.empty_cache()


def snapshot_check(state, model, cfg, arrs):
    """The training-log snapshot of the trained `--amp` model on the step's
    batch (`train.make_snapshot_fn`): its launches (the eval forward's
    epilogue and residual-tail kernels, no peak test), the heatmap
    bit-equal to the plain eval forward's (phase main's rule for ReLU),
    the model back in train mode with its BN buffers and the RNG states
    untouched; then the wall of one print step's two PNGs
    (`train.write_snapshots`, gt and pred) at b16 512^2."""
    import torch
    from real_time_helmet_detection_tpu_torch.train import (
        make_snapshot_fn, write_snapshots)
    from real_time_helmet_detection_tpu_torch.data.pipeline import Batch
    snapshot = make_snapshot_fn(model, cfg)
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    rng = (torch.get_rng_state(), torch.cuda.get_rng_state())
    snapshot(arrs[0])  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    heat = snapshot(arrs[0])  # THE snapshot the counts read
    torch.cuda.synchronize()
    counts = read_counts()
    want = expected_launches(dataclasses.replace(cfg, imsize=512),
                             "predict", torch.bfloat16)
    for key in ("peak_scores", "peak_vec", "peak_scalar"):
        want[key] = 0  # the snapshot decodes nothing
    require(counts == want, "launches per snapshot %s, want %s"
            % (counts, want))
    require(model.training, "the model is not back in train mode")
    require(all(torch.equal(v, buffers[k])
                for k, v in model.named_buffers())
            and torch.equal(rng[0], torch.get_rng_state())
            and torch.equal(rng[1], torch.cuda.get_rng_state()),
            "the snapshot moved a BN buffer or an RNG state")
    with plain_kernels():
        plain = snapshot(arrs[0])
    require(tuple(heat.shape) == (16, 128, 128, cfg.num_cls)
            and bool(torch.isfinite(heat).all()),
            "snapshot heatmap malformed: %s" % (tuple(heat.shape),))
    err = float((heat - plain).abs().max())
    require(torch.equal(heat, plain), "snapshot heatmap kernels vs plain: "
            "max abs err %g, not bit-equal" % err)
    host = Batch(*(a.cpu().numpy() for a in arrs), infos=[])
    with tempfile.TemporaryDirectory() as tmp:
        scfg = dataclasses.replace(cfg, save_path=tmp)
        os.makedirs(os.path.join(tmp, "training_log"))
        walls = []
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            write_snapshots(scfg, 0, i, host, snapshot)
            walls.append(time.perf_counter() - t0)
        pngs = sorted(os.listdir(os.path.join(tmp, "training_log")))
    require(len(pngs) == 4, "write_snapshots wrote %s" % pngs)
    state.setdefault("launches", {})["snapshot"] = counts
    state["snapshot"] = dict(walls=walls, err=err)
    log("train_main snapshot: launches %s per snapshot, no peak test; "
        "heatmap (16, 128, 128, 2) bit-equal to the plain eval forward; "
        "model back in train mode, BN buffers and RNG states untouched; "
        "one print step's gt + pred PNGs at b16 512^2: %s s" % (
            {k: v for k, v in counts.items() if v},
            ", ".join("%.3f" % w for w in walls)))


# ---------------------------------------------- accumulation and DDP phases


def accum_backward(model, arrs, cfg):
    """(loss, summed gradients, buffers) of one host step of cfg's
    accumulation (`--grad-accum` micro-batches) without the update; the
    gradients are cleared after."""
    import torch
    from real_time_helmet_detection_tpu_torch.train import make_train_step
    opt = torch.optim.SGD(model.parameters(), lr=0.0)  # zero_grad only
    step = make_train_step(model, opt, lambda count: 0.0, cfg)
    losses = step(0, *arrs, update=False)
    torch.cuda.synchronize()
    out = (float(losses["total"]),
           {n: p.grad.detach().clone() for n, p in model.named_parameters()},
           {n: t.detach().clone() for n, t in model.named_buffers()})
    model.zero_grad(set_to_none=True)
    return out


def check_accum_step(model, model32, arrs, cfg, cfg32):
    """The bf16 `--grad-accum 2` step through the kernels against the same
    step through the plain versions, under train_main's bf16 rule (loss
    rel 1e-3; summed gradient and running statistics no further from the
    f32 plain step than 1.5x the bf16 plain path), cudnn.deterministic;
    the models' buffers are restored after."""
    import torch
    buffers = {n: t.detach().clone() for n, t in model.named_buffers()}
    torch.backends.cudnn.deterministic = True
    try:
        lk, gk, bk = accum_backward(model, arrs, cfg)
        model.load_state_dict(buffers, strict=False)
        with plain_kernels():
            lp, gp, bp = accum_backward(model, arrs, cfg)
            model.load_state_dict(buffers, strict=False)
            lp32, gp32, bp32 = accum_backward(model32, arrs, cfg32)
            model32.load_state_dict(buffers, strict=False)
    finally:
        torch.backends.cudnn.deterministic = False
        model.load_state_dict(buffers, strict=False)
    e = dict(loss=abs(lk - lp) / abs(lp),
             grad_vs_f32=(rel_l2(gk, gp32), rel_l2(gp, gp32)),
             stats_vs_f32=(rel_l2(bk, bp32), rel_l2(bp, bp32)))
    log("accum: --grad-accum 2 bf16 step kernels vs plain: loss %.6f vs "
        "%.6f, rel err %.3g (tol %g); against the f32 plain step: summed "
        "gradient kernels %.3g, plain %.3g, running statistics kernels "
        "%.3g, plain %.3g (kernels at most %gx plain)" % (
            lk, lp, e["loss"], STEP_TOL["bf16_loss"], *e["grad_vs_f32"],
            *e["stats_vs_f32"], STEP_TOL["bf16_ratio"]))
    ratio = STEP_TOL["bf16_ratio"]
    require(e["loss"] <= STEP_TOL["bf16_loss"]
            and e["grad_vs_f32"][0] <= ratio * e["grad_vs_f32"][1]
            and e["stats_vs_f32"][0] <= ratio * e["stats_vs_f32"][1],
            "--grad-accum 2 step kernels further from the f32 step than "
            "the plain versions")
    return e


class RepeatLoader:
    """`n` copies of one host batch, as `train_epoch` reads a loader."""

    def __init__(self, arrays, n):
        self.arrays, self.n = arrays, n

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return self.n

    def __iter__(self):
        from real_time_helmet_detection_tpu_torch.data.pipeline import Batch
        for _ in range(self.n):
            yield Batch(*self.arrays, infos=[])


def params_of(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def moved(a, b):
    """Does any tensor of name -> tensor dict `a` differ from b's?"""
    import torch
    return any(not torch.equal(a[n], b[n]) for n in a)


def phase_accum(state):
    """Gradient accumulation at the flagship's width, b16 512^2 --amp:
    one `--grad-accum 2` step through the kernels against the plain
    versions (train_main's bf16 rule) and its launches (twice one step's
    derived counts); three `--sub-divisions 2` host steps of an epoch of 3
    through `train_epoch` (no update after step 1, one after step 2, the
    flush at step 3); one `--grad-accum 2` step against two `--sub-
    divisions 2` steps on its halves under SGD in f32 (parameters rel L2
    1e-5, cudnn.deterministic); train images/s and peak memory of
    grad-accum 1 and 2 in alternating windows."""
    import torch
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.ops.loss import LossLog
    from real_time_helmet_detection_tpu_torch.train import train_epoch
    cfg = Config(batch_size=16, amp=True, grad_accum=2)
    model, opt, _, step = extras_trainer(cfg)
    arrs = train_batch()
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    saved_opt = opt.state_dict()
    step(0, *arrs)  # warm-up on a throwaway copy of the weights
    torch.cuda.synchronize()
    model.load_state_dict(saved)
    opt.load_state_dict(saved_opt)
    cfg32 = Config(batch_size=16, grad_accum=2)
    model32 = extras_trainer(cfg32)[0]
    model32.load_state_dict(model.state_dict())
    errs = check_accum_step(model, model32, arrs, cfg, cfg32)
    del model32
    reset_counts()
    step(0, *arrs)  # THE --grad-accum 2 run the counts read
    torch.cuda.synchronize()
    counts = read_counts()
    one = expected_launches(Config(batch_size=16, imsize=512, amp=True),
                            "train", torch.bfloat16)
    want = {k: 2 * v for k, v in one.items()}
    require(counts == want, "launches per --grad-accum 2 step %s, want "
            "twice one step's %s" % (counts, one))
    state.setdefault("launches", {})["accum"] = counts

    # --sub-divisions 2 over an epoch of 3 host steps
    cfg_sd = Config(batch_size=16, amp=True, sub_divisions=2)
    model_sd, _, _, step_sd = extras_trainer(cfg_sd)
    snaps = [params_of(model_sd)]

    def recording(count, *a, update):
        out = step_sd(count, *a, update=update)
        torch.cuda.synchronize()
        snaps.append(params_of(model_sd))
        return out

    host = [a.cpu().numpy() for a in arrs]
    updates = train_epoch(cfg_sd, 0, RepeatLoader(host, 3), recording,
                          arrs[0].device, LossLog(), 0, chief=False)
    moves = [moved(a, b) for a, b in zip(snaps, snaps[1:])]
    require(moves == [False, True, True] and updates == 2,
            "--sub-divisions 2 over 3 steps: parameters moved %s, %d "
            "updates; want [False, True, True], 2" % (moves, updates))
    del model_sd, step_sd, snaps

    # grad-accum 2 on a batch == sub-divisions 2 on its halves (SGD, f32)
    cfg_a = Config(batch_size=16, grad_accum=2, optim="SGD", lr=1e-2)
    cfg_b = Config(batch_size=8, sub_divisions=2, optim="SGD", lr=1e-2)
    model_a, _, _, step_a = extras_trainer(cfg_a)
    model_b, _, _, step_b = extras_trainer(cfg_b)
    torch.backends.cudnn.deterministic = True
    try:
        step_a(0, *arrs)
        step_b(0, *(a[:8] for a in arrs), update=False)
        step_b(0, *(a[8:] for a in arrs), update=True)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    pa, pb = params_of(model_a), params_of(model_b)
    equiv = rel_l2(pa, pb)
    bit_equal = not moved(pa, pb)
    require(equiv <= 1e-5, "--grad-accum 2 vs --sub-divisions 2 on its "
            "halves (SGD, f32): parameters rel L2 %.3g > 1e-5" % equiv)
    del model_a, model_b, step_a, step_b

    # images/s and peak memory, grad-accum 1 against 2
    cfg1 = Config(batch_size=16, amp=True)
    model1, _, _, step1 = extras_trainer(cfg1)
    steps = {"grad_accum_1": step1, "grad_accum_2": step}
    peaks = {}
    for name, fn in steps.items():
        fn(100, *arrs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn(101, *arrs)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
    rates = alternating_rates(steps, arrs, window_s=0.5)
    state["accum"] = dict(errs=errs, counts=counts, equiv=equiv,
                          bit_equal=bit_equal, rates=rates, peak_gb=peaks)
    log("accum: launches per --grad-accum 2 step %s (twice the derived "
        "one-step counts); --sub-divisions 2 over an epoch of 3: "
        "parameters moved after each step %s, %d updates; --grad-accum 2 "
        "vs --sub-divisions 2 on its halves (SGD, f32): parameters rel L2 "
        "%.3g (bit-equal %s)" % (counts, moves, updates, equiv, bit_equal))
    for name, r in rates.items():
        log("accum: train step b16 512^2 --amp %s: median %.1f img/s "
            "(%.2f ms per step), min %.1f, max %.1f over %d windows: %s; "
            "peak memory %.2f GB" % (
                name, r["median_ips"], r["ms_per_step"], min(r["ips"]),
                max(r["ips"]), len(r["ips"]),
                ", ".join("%.1f" % v for v in r["ips"]), peaks[name]))
    del model, opt, step, model1, step1, steps, arrs
    torch.cuda.empty_cache()


DDP_LR = 1e-2  # SGD in the world-2 check: the update is -lr * gradient
DDP_TIMEOUT_S = 300


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(cmds, what, timeout=DDP_TIMEOUT_S):
    """Start every command at once; each must exit 0 within `timeout`
    s (together); none outlives the call. Returns their outputs."""
    procs = [subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        require(False, "%s: a rank did not finish in %d s" % (what, timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, "%s: rank %d exit %d:\n%s" % (
            what, rank, p.returncode, "\n".join(out.splitlines()[-15:])))
    return outs


def ddp_step_result(model, losses, counts, ms):
    """What phase ddp compares of one step, on the host."""
    return dict(loss=float(losses["total"]), counts=counts, ms=ms,
                params={n: p.detach().cpu() for n, p in
                        model.named_parameters()},
                buffers={n: t.detach().cpu() for n, t in
                         model.named_buffers()})


def timed_step(model, opt, step, arrs):
    """One warm-up step on a throwaway copy of the state, then THE step:
    (losses, launch counts, ms)."""
    import torch
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    saved_opt = opt.state_dict()
    step(0, *arrs)
    torch.cuda.synchronize()
    model.load_state_dict(saved)
    opt.load_state_dict(saved_opt)
    reset_counts()
    t0 = time.perf_counter()
    losses = step(0, *arrs)
    torch.cuda.synchronize()
    return losses, read_counts(), 1e3 * (time.perf_counter() - t0)


def ddp_worker(rank, world, port, out_dir):
    """One rank of phase ddp's world-2 step: the f32 flagship (SGD) under
    DistributedDataParallel over gloo on cuda:0, its 8 rows of the
    16-image batch; writes `rank<r>.pt`."""
    import torch
    from real_time_helmet_detection_tpu_torch import parallel
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.optim import make_lr_schedule
    from real_time_helmet_detection_tpu_torch.train import make_train_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config(batch_size=16, optim="SGD", lr=DDP_LR, world_size=world,
                 rank=rank, dist_url="tcp://localhost:%d" % port,
                 dist_backend="gloo")
    dev = parallel.init_distributed(cfg)
    parallel.barrier_synced_build(dev)
    model, opt, _, _ = extras_trainer(cfg)
    net = torch.nn.parallel.DistributedDataParallel(
        model, device_ids=[dev], broadcast_buffers=False)
    step = make_train_step(model, opt, make_lr_schedule(cfg, 1000), cfg,
                           net=net)
    b = parallel.local_batch_size(cfg)
    arrs = [a[rank * b:(rank + 1) * b].contiguous() for a in train_batch()]
    losses, counts, ms = timed_step(model, opt, step, arrs)
    total = parallel.all_reduce_sum_(losses["total"].clone()) / world
    out = ddp_step_result(model, {"total": total}, counts, ms)
    parallel.destroy_process_group()
    torch.save(out, os.path.join(out_dir, "rank%d.pt" % rank))


def phase_ddp(state):
    """Data parallelism on the one card. (a) World 1 over NCCL: the
    DDP-wrapped flagship --amp step at b16 512^2 against the unwrapped
    step on the same batch (cudnn.deterministic): bit-equal, launches as
    one step's. (b) World 2 over gloo, two processes on cuda:0 with 8
    images each, f32, SGD: against the single-process 16-image step, the
    loss rel 1e-5, the update (the gradient) within train_main's f32 rel
    L2 5e-3, the running statistics bit-equal across the ranks and rel L2
    1e-5 against the single step, launches per rank as one step's at b8.
    (c) The eval CLI at world 2 (gloo, one card) on a 32-image fixture:
    rank 0's mAP and pickle against the single-process CLI's, the txt
    files and the pickle from rank 0 alone."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        make_synthetic_voc
    from real_time_helmet_detection_tpu_torch.optim import make_lr_schedule
    from real_time_helmet_detection_tpu_torch.train import make_train_step
    arrs = train_batch()
    # (a) world 1, NCCL
    cfg = Config(batch_size=16, amp=True)
    dist.init_process_group("nccl", init_method="tcp://localhost:%d"
                            % free_port(), world_size=1, rank=0)
    torch.backends.cudnn.deterministic = True
    try:
        model, opt, _, step = extras_trainer(cfg)
        model_d, opt_d, _, _ = extras_trainer(cfg)
        net = torch.nn.parallel.DistributedDataParallel(
            model_d, device_ids=[0], broadcast_buffers=False)
        step_d = make_train_step(model_d, opt_d,
                                 make_lr_schedule(cfg, 1000), cfg, net=net)
        plain = ddp_step_result(model, *timed_step(model, opt, step, arrs))
        wrapped = ddp_step_result(model_d,
                                  *timed_step(model_d, opt_d, step_d, arrs))
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()
    bit_equal = plain["loss"] == wrapped["loss"] and not moved(
        plain["params"], wrapped["params"]) and not moved(
        plain["buffers"], wrapped["buffers"])
    one = expected_launches(Config(batch_size=16, imsize=512, amp=True),
                            "train", torch.bfloat16)
    rel_p = rel_l2(wrapped["params"], plain["params"])
    require(wrapped["counts"] == one, "launches of the DDP step %s, want "
            "%s" % (wrapped["counts"], one))
    require(bit_equal or rel_p <= 1e-6, "DDP world 1 (NCCL) vs the "
            "unwrapped step: parameters rel L2 %.3g" % rel_p)
    log("ddp (a) world 1, NCCL, flagship --amp b16 512^2: DDP step "
        "bit-equal to the unwrapped step %s (loss %.7f vs %.7f, "
        "parameters rel L2 %.3g); %.2f vs %.2f ms (one step each, "
        "cudnn.deterministic); launches as one step's" % (
            bit_equal, wrapped["loss"], plain["loss"], rel_p,
            wrapped["ms"], plain["ms"]))
    del model, opt, step, model_d, opt_d, step_d, net
    torch.cuda.empty_cache()

    # (b) world 2, gloo, both ranks on cuda:0, f32
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_") as tmp:
        port = free_port()
        run_ranks([[sys.executable, os.path.join(REPO, "chip_smoke.py"),
                    "--ddp-worker", str(rank), "2", str(port), tmp]
                   for rank in range(2)], "ddp world 2 step")
        ranks = [torch.load(os.path.join(tmp, "rank%d.pt" % r),
                            weights_only=False) for r in range(2)]
    cfg1 = Config(batch_size=16, optim="SGD", lr=DDP_LR)
    model, opt, _, step = extras_trainer(cfg1)
    p0 = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    single = ddp_step_result(model, *timed_step(model, opt, step, arrs))
    del model, opt, step
    r0, r1 = ranks
    delta = lambda r: {n: r["params"][n] - p0[n] for n in p0}
    e = dict(loss=abs(r0["loss"] - single["loss"]) / abs(single["loss"]),
             update=rel_l2(delta(r0), delta(single)),
             stats=rel_l2(r0["buffers"], single["buffers"]))
    same_ranks = r0["loss"] == r1["loss"] and not moved(
        r0["params"], r1["params"]) and not moved(r0["buffers"],
                                                  r1["buffers"])
    per_rank = expected_launches(Config(batch_size=8, imsize=512), "train",
                                 torch.float32)
    log("ddp (b) world 2, gloo on one card, f32 b8 a rank: loss %.7f vs "
        "the single 16-image step's %.7f, rel err %.3g (tol 1e-5); update "
        "rel L2 %.3g (tol %g); running statistics rel L2 %.3g (tol 1e-5); "
        "ranks bit-equal %s; step %.1f / %.1f ms a rank (first timed step "
        "after one warm-up) against %.1f ms single" % (
            r0["loss"], single["loss"], e["loss"], e["update"],
            STEP_TOL["f32_grad"], e["stats"], same_ranks, r0["ms"],
            r1["ms"], single["ms"]))
    require(e["loss"] <= 1e-5 and e["update"] <= STEP_TOL["f32_grad"]
            and e["stats"] <= 1e-5, "ddp world 2 vs the single step "
            "beyond tolerance: %s" % e)
    require(not moved(r0["buffers"], r1["buffers"]),
            "running statistics differ between the ranks")
    require(r0["counts"] == per_rank and r1["counts"] == per_rank,
            "launches per rank %s / %s, want %s"
            % (r0["counts"], r1["counts"], per_rank))

    # (c) eval CLI at world 2 on one card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_eval_") as tmp:
        root = make_synthetic_voc(os.path.join(tmp, "voc"), num_train=0,
                                  num_test=32, imsize=(512, 512), seed=0)
        base = [sys.executable, "-m", "real_time_helmet_detection_tpu_torch",
                "--data", root, "--imsize", "512", "--batch-size", "16",
                "--amp", "--serve-max-wait-ms", "50"]
        # the one-process eval beside the world-2 pair, all on the card
        t0 = time.time()
        port = free_port()
        single_out, *outs = run_ranks(
            [base + ["--save-path", os.path.join(tmp, "single")]]
            + [base + ["--world-size", "2", "--rank", str(r), "--dist-url",
                       "tcp://localhost:%d" % port, "--dist-backend",
                       "gloo", "--save-path", os.path.join(tmp, "rank%d" % r)]
               for r in range(2)], "eval CLI (0 one process, 1-2 world 2)")
        t1 = time.time()
        maps = [[l.split(": mAP ", 1)[1] for l in out.splitlines()
                 if ": mAP " in l] for out in (single_out, *outs)]
        files = {}
        for name in ("single", "rank0", "rank1"):
            d = os.path.join(tmp, name)
            pk = os.path.join(d, "prediction_results.pickle")
            got = None
            if os.path.exists(pk):
                with open(pk, "rb") as f:
                    got = pickle.load(f)
            files[name] = (len(glob.glob(os.path.join(
                d, "results", "txt", "*.txt"))), got)
    require(len(maps[0]) == 1 and maps[1] == maps[0] and maps[2] == [],
            "eval mAP lines: single %s, rank 0 %s, rank 1 %s" % tuple(maps))
    require(files["rank0"][0] == 32 and files["rank1"] == (0, None)
            and files["single"][0] == 32, "eval files: txt single %d, rank "
            "0 %d, rank 1 %d, rank 1 pickle %s" % (
                files["single"][0], files["rank0"][0], files["rank1"][0],
                files["rank1"][1] is not None))
    want, got = files["single"][1], files["rank0"][1]
    require(got is not None and sorted(got) == sorted(want),
            "rank 0's pickle does not hold the split's images")
    same = all(all(np.array_equal(got[k][f], want[k][f])
                   for f in ("box", "cls", "score")) for k in want)
    require(all(len(got[k]["score"]) == len(want[k]["score"])
                for k in want), "rank 0's pickle: detection counts differ")
    state["ddp"] = dict(bit_equal=bit_equal, world2=e, same_ranks=same_ranks,
                        ms=(r0["ms"], r1["ms"], single["ms"]),
                        eval_map=maps[0][0], eval_same=same,
                        eval_s=t1 - t0)
    log("ddp (c) eval CLI on 32 images, b16 512^2 --amp: one process %s; "
        "world 2 over gloo on one card: rank 0 %s, rank 1 no mAP line, no "
        "txt, no pickle (the three processes side by side, %.1f s); rank "
        "0's 32 txt files and pickle, its detections bit-equal to the "
        "single process's %s" % (maps[0][0], maps[1][0], t1 - t0, same))


# ----------------------------------------------------- train-extras phase


def peak_gb(step, arrs, count=0):
    """Peak device memory (GB) of one step."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(count, *arrs)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def launches_of(step, arrs, count=0):
    """The launch counters of one step."""
    import torch
    reset_counts()
    out = step(count, *arrs)
    torch.cuda.synchronize()
    return read_counts(), out


def syncs_in(fn):
    """(host syncs warned inside fn, fn's result): CUDA's sync debug mode."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            out = fn()
            torch.cuda.set_sync_debug_mode(0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode's one-time notice ("... does not yet detect all
    # synchronizing operations") is not a sync
    return sum("synchroniz" in str(w.message)
               and "prototype feature" not in str(w.message)
               for w in caught), out


def ste_sites_checked(step, arrs, errs):
    """Run one train step with each int8 kernel wrapper (the abs-max,
    #16, #14, #15) held bit-equal to its plain version on the very
    operands the step gives it (its activations, abs-max step, weight
    codes and scales);
    returns {(kind, input shape, out channels, k): calls} of its STE
    convs, kind dense | dw. `errs` gets each comparison's max abs error
    by site."""
    import torch
    from real_time_helmet_detection_tpu_torch.ops import qconv
    sites = {}

    def checked(name, real, ref):
        if name == "abs_max":
            def one(x):
                got = real(x)
                key = ("abs_max", tuple(x.shape), str(x.dtype))
                errs[key] = max(errs.get(key, 0.0), compare(
                    "abs_max %s" % (key,), got, ref(x), "nan_equal"))
                return got
            return one

        def wrapper(q, w, *args):
            got = real(q, w, *args)
            if name == "quantize_act":
                key = ("quantize_act", tuple(q.shape), str(q.dtype))
            else:
                kind = "dw" if name == "conv_dw" else "dense"
                key = (kind, tuple(q.shape)) + (
                    (w.shape[1], 3) if kind == "dw" else tuple(w.shape[:2]))
                sites[key] = sites.get(key, 0) + 1
            err = compare("%s %s" % (name, key), got, ref(q, w, *args),
                          "equal")
            errs[key] = max(errs.get(key, 0.0), err)
            return got
        return wrapper

    with swapped([(qconv, name, checked(name, getattr(qconv, name),
                                        getattr(qconv, name + "_reference")))
                  for name in ("abs_max", "quantize_act", "conv_dense",
                               "conv_dw")]):
        step(0, *arrs)
    torch.cuda.synchronize()
    return sites


def check_int8_step(model, model32, arrs, cfg, cfg32, label):
    """The --fwd-dtype int8 step through the kernels against the plain
    versions by train_main's bf16 rule: the bf16 loss within rel 1e-3,
    the bf16 gradient and statistics no further from the f32 plain step
    than 1.5x the plain path's (the f32 kernels-vs-plain errors are
    logged: an int8 code that flips on a last-bit BN difference moves
    every later quantization step, so the f32 rule does not apply)."""
    (lk, gk, bk), (lp, gp, bp) = kernels_and_plain(model, arrs, cfg)
    (lk32, gk32, bk32), (lp32, gp32, bp32) = kernels_and_plain(
        model32, arrs, cfg32)
    e = dict(bf16_loss=abs(lk - lp) / abs(lp),
             bf16_grad_vs_f32=(rel_l2(gk, gp32), rel_l2(gp, gp32)),
             bf16_stats_vs_f32=(rel_l2(bk, bp32), rel_l2(bp, bp32)),
             f32_loss=abs(lk32 - lp32) / abs(lp32),
             f32_grad=rel_l2(gk32, gp32), f32_stats=rel_l2(bk32, bp32))
    log("train_extras int8 %s kernels vs plain: bf16 loss %.6f vs %.6f rel "
        "%.3g (tol %g); from the f32 plain step: gradient kernels %.3g plain "
        "%.3g, statistics kernels %.3g plain %.3g (kernels at most %gx); "
        "f32 kernels vs plain: loss rel %.3g, gradient %.3g, statistics "
        "%.3g" % (label, lk, lp, e["bf16_loss"], STEP_TOL["bf16_loss"],
                  *e["bf16_grad_vs_f32"], *e["bf16_stats_vs_f32"],
                  STEP_TOL["bf16_ratio"], e["f32_loss"], e["f32_grad"],
                  e["f32_stats"]))
    ratio = STEP_TOL["bf16_ratio"]
    require(e["bf16_loss"] <= STEP_TOL["bf16_loss"]
            and e["bf16_grad_vs_f32"][0] <= ratio * e["bf16_grad_vs_f32"][1]
            and e["bf16_stats_vs_f32"][0]
            <= ratio * e["bf16_stats_vs_f32"][1],
            "int8 %s bf16 train step kernels further from the f32 step "
            "than the plain versions" % label)
    return e


def int8_trainer_checked(cfg, arrs, label):
    """cfg's --fwd-dtype int8 model and step on the card, checked: one
    step with every int8 kernel bit-equal to its plain version on its own
    operands (`ste_sites_checked`), each STE site's shape then on every
    kernel of its conv against the plain version on seeded operands
    (`qconv_case`), and the step through the kernels against the plain
    versions with an f32 twin (`check_int8_step`); the weights are the
    seeded ones again after. Returns (model, step, STE sites, errors)."""
    import torch
    cfg32 = dataclasses.replace(cfg, amp=False)
    model, _, _, step = extras_trainer(cfg)
    model32 = extras_trainer(cfg32)[0]
    model32.load_state_dict(model.state_dict())
    op_errs = {}
    sites = ste_sites_checked(step, arrs, op_errs)  # also the warm-up
    model.load_state_dict(model32.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(6)
    case_errs = {}
    n = sum(qconv_case(kind, shape, cout, k, gen, case_errs,
                       ("ste", kind, shape, cout, k))
            for kind, shape, cout, k in sorted(sites))
    errs = check_int8_step(model, model32, arrs, cfg, cfg32, label)
    errs.update(ops=len(op_errs), ops_max_abs_err=max(op_errs.values()),
                sites=len(sites), cases=n)
    log("train_extras int8 %s: %d STE conv shapes (%d calls); #16/#14/#15 "
        "bit-equal to the plain versions on the step's own operands at %d "
        "(kernel, shape) keys, and on every kernel of each shape's conv on "
        "seeded operands (%d comparisons)" % (
            label, len(sites), sum(sites.values()), len(op_errs), n))
    del model32
    return model, step, sites, errs


def extras_int8(state, arrs):
    """--fwd-dtype int8 b16 512^2 --amp, on the flagship and on the edge
    architecture (ghost: #15 in training): each checked by
    `int8_trainer_checked` (#14-#16 bit-equal to the plain versions at
    the step's STE sites, the step through the kernels against the plain
    versions by train_main's bf16 rule), its launches as derived (#16 at
    every STE site, #14 on wgmma), the recorded STE sites those of
    `ste_walk`; the flagship's img/s and peak memory against --fwd-dtype
    bf16 in alternating windows."""
    import torch
    from real_time_helmet_detection_tpu_torch.config import Config
    out = dict(errs={}, launches={}, sites={})
    flagship = Config(batch_size=16, imsize=512, amp=True, fwd_dtype="int8")
    edge = dataclasses.replace(flagship, **VARIANT_CONFIGS["edge-arch"])
    for label, cfg in (("flagship", flagship), ("edge-arch", edge)):
        model, step, sites, out["errs"][label] = int8_trainer_checked(
            cfg, arrs, label)
        counts, losses = launches_of(step, arrs)
        want = expected_launches(cfg, "train", torch.bfloat16)
        dense, dw = ste_walk(cfg)
        calls = {kind: sum(n for key, n in sites.items() if key[0] == kind)
                 for kind in ("dense", "dw")}
        require(counts == want and math.isfinite(float(losses["total"]))
                and counts["qconv_dense_wgmma"] == dense == calls["dense"]
                and len(dw) == calls["dw"] == counts["qconv_dw"],
                "%s --fwd-dtype int8 launches per step %s, want %s; STE "
                "calls %s, ste_walk %d dense, %d depthwise (loss %s)" % (
                    label, counts, want, calls, dense, len(dw),
                    float(losses["total"])))
        out["launches"][label], out["sites"][label] = counts, len(sites)
        if label == "flagship":
            require(dense == 35 and not dw, "flagship: %d dense, %d "
                    "depthwise STE sites, want 35 and 0" % (dense, len(dw)))
            out["loss"] = float(losses["total"])
            _, _, _, step_bf = extras_trainer(dataclasses.replace(
                cfg, fwd_dtype="bf16"))
            step_bf(0, *arrs)
            out["rates"] = alternating_rates({"int8": step, "bf16": step_bf},
                                             arrs, window_s=0.5)
            out["peak_gb"] = {"int8": peak_gb(step, arrs),
                              "bf16": peak_gb(step_bf, arrs)}
            del step_bf
        else:
            require(counts["qconv_dw"] > 0, "edge-arch: no #15 launch")
        del model, step
        torch.cuda.empty_cache()
    launches = out["launches"]
    counts = out["launches"] = launches["flagship"]
    counts_e = out["launches_edge"] = launches["edge-arch"]
    log("train_extras int8: launches a flagship step %s (#16 %d, #14 %d on "
        "wgmma), edge-arch %s (#15 %d: %d tiled)" % (
            {k: v for k, v in counts.items() if v}, counts["quantize_act"],
            counts["qconv_dense_wgmma"], {k: v for k, v in counts_e.items()
                                          if v}, counts_e["qconv_dw"],
            counts_e["qconv_dw_tiled"]))
    for name, r in out["rates"].items():
        log("train_extras int8: --fwd-dtype %s b16 512^2 --amp: median %.1f "
            "img/s (%.2f ms a step), min %.1f max %.1f; peak %.2f GB" % (
                name, r["median_ips"], r["ms_per_step"], min(r["ips"]),
                max(r["ips"]), out["peak_gb"][name]))
    return out


def weight_casts(model, arrs, cfg):
    """aten._to_copy calls on tensors of a conv weight's shape in one
    forward (a TorchDispatchMode; torch.profiler here disturbed the later
    phases' CUDA traces): the fp32 policy's per-call weight casts."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from real_time_helmet_detection_tpu_torch.train import loss_fn
    shapes = {tuple(p.shape) for p in model.parameters() if p.dim() == 4}
    count = [0]

    class Casts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._to_copy.default \
                    and tuple(args[0].shape) in shapes:
                count[0] += 1
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), Casts():
        loss_fn(model, *arrs, cfg)
    torch.cuda.synchronize()
    return count[0]


def extras_policy(state, arrs):
    """--param-policy bf16-compute, flagship b16 512^2 --amp: parameters
    bf16, masters f32, no per-call weight cast (the fp32 policy casts each
    conv weight once a forward); one SGD
    step's loss (rtol 1e-3) and update (relative L2 2e-2, the JAX
    package's documented rtol for the policy's gradients) against the
    fp32 policy's; img/s and peak memory against it, Adam."""
    import torch
    from real_time_helmet_detection_tpu_torch.config import Config
    out = {}
    sgd = {}
    for pol in ("fp32", "bf16-compute"):
        cfg = Config(batch_size=16, imsize=512, amp=True, param_policy=pol,
                     optim="SGD", lr=1e-3)
        model, opt, _, step = extras_trainer(cfg)
        p0 = [m.detach().float().clone() for m in (
            opt.masters if pol != "fp32" else model.parameters())]
        torch.backends.cudnn.deterministic = True
        try:
            loss = float(step(0, *arrs)["total"])
        finally:
            torch.backends.cudnn.deterministic = False
        now = opt.masters if pol != "fp32" else list(model.parameters())
        sgd[pol] = (loss, torch.cat([(m.detach().float() - a).flatten()
                                     for m, a in zip(now, p0)]))
        if pol != "fp32":
            require({p.dtype for p in model.parameters()} == {torch.bfloat16}
                    and {m.dtype for m in opt.masters} == {torch.float32}
                    and all(torch.equal(p, m.bfloat16()) for p, m in
                            zip(model.parameters(), opt.masters)),
                    "bf16-compute: parameters bf16 of the f32 masters")
        del model, opt, step
    loss_rel = abs(sgd["bf16-compute"][0] - sgd["fp32"][0]) / abs(
        sgd["fp32"][0])
    upd = float((sgd["bf16-compute"][1] - sgd["fp32"][1]).norm()
                / sgd["fp32"][1].norm())
    require(loss_rel <= 1e-3 and upd <= 2e-2, "bf16-compute vs fp32 "
            "policy: loss rel %.3g (tol 1e-3), update rel L2 %.3g (tol "
            "2e-2)" % (loss_rel, upd))
    steps, casts, peaks, models = {}, {}, {}, {}
    for pol in ("fp32", "bf16-compute"):
        cfg = Config(batch_size=16, imsize=512, amp=True, param_policy=pol)
        models[pol], _, _, steps[pol] = extras_trainer(cfg)
        steps[pol](0, *arrs)
        peaks[pol] = peak_gb(steps[pol], arrs)
    rates = alternating_rates(steps, arrs, window_s=0.5)
    for pol, model in models.items():
        casts[pol] = weight_casts(model, arrs, dataclasses.replace(
            cfg, param_policy=pol))
    n_weights = sum(p.dim() == 4 for p in model.parameters())
    del models, model
    require(casts["bf16-compute"] == 0 and casts["fp32"] == n_weights,
            "weight-shaped casts a forward: bf16-compute %d (want 0), the "
            "fp32 policy %d (want one for each of the %d conv weights)"
            % (casts["bf16-compute"], casts["fp32"], n_weights))
    out.update(loss_rel=loss_rel, update_rel_l2=upd, casts=casts,
               peak_gb=peaks, rates=rates)
    del steps
    torch.cuda.empty_cache()
    log("train_extras bf16-compute: one SGD step vs the fp32 policy: loss "
        "rel %.3g, update rel L2 %.3g; conv-weight casts a forward %d (fp32 "
        "policy %d)" % (loss_rel, upd, casts["bf16-compute"], casts["fp32"]))
    for name, r in out["rates"].items():
        log("train_extras bf16-compute: --param-policy %s: median %.1f img/s "
            "(%.2f ms a step), min %.1f max %.1f; peak %.2f GB" % (
                name, r["median_ips"], r["ms_per_step"], min(r["ips"]),
                max(r["ips"]), peaks[name]))
    return out


def grads_and_stats(model, arrs, cfg):
    import torch
    from real_time_helmet_detection_tpu_torch.train import loss_fn
    model.zero_grad(set_to_none=True)
    total, _ = loss_fn(model, *arrs, cfg)
    total.backward()
    torch.cuda.synchronize()
    return (total.detach().clone(),
            [p.grad.clone() for p in model.parameters()],
            [b.clone() for b in model.buffers()])


def extras_remat(state, arrs):
    """--remat stacks and full: f32 (TF32 off, cudnn.deterministic), the
    loss, the gradients and the running statistics bit-equal to --remat
    none from the same weights (so the statistics moved once); launches
    as derived, the recompute included; peak memory of each at --amp."""
    import torch
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.evaluate import init_weights
    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        build_model
    out = dict(peak_gb={}, launches={})
    torch.backends.cudnn.deterministic = True
    try:
        base = init_weights(build_model(Config(batch_size=16)), 3).state_dict()
        runs = {}
        for mode in ("none", "none", "stacks", "full"):
            cfg = Config(batch_size=16, imsize=512, remat=mode)
            model = build_model(cfg).cuda().train()
            model.load_state_dict(base)
            reset_counts()
            run = grads_and_stats(model, arrs, cfg)
            counts = read_counts()
            want = expected_launches(cfg, "train", torch.float32)
            require(counts == want, "--remat %s launches %s, want %s"
                    % (mode, counts, want))
            out["launches"][mode] = counts
            if mode in runs:
                require(all(torch.equal(a, b) for a, b in zip(
                    [run[0]] + run[1] + run[2],
                    [runs[mode][0]] + runs[mode][1] + runs[mode][2])),
                    "two --remat none steps differ: the step is not "
                    "deterministic")
            runs[mode] = run
            del model
        l0, g0, b0 = runs["none"]
        for mode in ("stacks", "full"):
            l1, g1, b1 = runs[mode]
            same = (torch.equal(l0, l1)
                    and all(torch.equal(a, b) for a, b in zip(g0, g1))
                    and all(torch.equal(a, b) for a, b in zip(b0, b1)))
            require(same, "--remat %s not bit-equal to none (loss %s vs %s)"
                    % (mode, float(l1), float(l0)))
    finally:
        torch.backends.cudnn.deterministic = False
    del runs
    torch.cuda.empty_cache()
    # peak memory and ms a step at --amp: the flagship (1 stack) and the
    # quality architecture (2 stacks: one stack's activations at a time)
    for arch, stacks in (("flagship", 1), ("quality-arch", 2)):
        steps = {}
        for mode in ("none", "stacks", "full"):
            cfg = Config(batch_size=16, imsize=512, amp=True, remat=mode,
                         num_stack=stacks)
            _, _, _, steps[mode] = extras_trainer(cfg)
            steps[mode](0, *arrs)
            out["peak_gb"]["%s %s" % (arch, mode)] = peak_gb(steps[mode],
                                                             arrs)
        rates = alternating_rates(steps, arrs, windows=2, window_s=0.5)
        for mode, r in rates.items():
            out.setdefault("ms", {})["%s %s" % (arch, mode)] = \
                r["ms_per_step"]
        del steps
        torch.cuda.empty_cache()
    log("train_extras remat: f32 loss, gradients, statistics bit-equal to "
        "none (stacks, full); launches #4 %s; --amp peak GB %s; ms a step "
        "%s" % ({m: c["bn_stats"] for m, c in out["launches"].items()},
                {m: round(v, 3) for m, v in out["peak_gb"].items()},
                {m: round(v, 2) for m, v in out["ms"].items()}))
    return out


def extras_ema(state, arrs):
    """EMA (decay 0.9), flagship --amp: after 3 steps equal to the host
    recurrence e = d e + (1 - d) p (float32, each product rounded); a
    checkpoint of it, its snapshot beside, through the eval CLI with
    --ema-eval (the serving engine) to the mAP and detections of the
    EMA weights loaded as an npz."""
    import pickle

    import numpy as np
    import torch
    from real_time_helmet_detection_tpu_torch.__main__ import main
    from real_time_helmet_detection_tpu_torch.config import (Config,
                                                             save_config)
    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        make_synthetic_voc
    from real_time_helmet_detection_tpu_torch.ops.loss import LossLog
    from real_time_helmet_detection_tpu_torch.train import save_checkpoint
    d = 0.9
    cfg = Config(batch_size=16, imsize=512, amp=True, ema_decay=d)
    model, opt, ema, step = extras_trainer(cfg)
    host = [p.detach().cpu().numpy().copy() for p in model.parameters()]
    for i in range(3):
        step(i, *arrs)
        p = [t.detach().cpu().numpy() for t in model.parameters()]
        host = [np.float32(d) * e + np.float32(1 - d) * q
                for e, q in zip(host, p)]
    err = max(float(np.abs(t.cpu().numpy() - e).max())
              for t, e in zip(ema.tensors, host))
    require(err == 0.0, "EMA after 3 steps vs the host recurrence: max abs "
            "%.3g" % err)
    out = dict(ema_max_abs_err=err)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ema_") as tmp:
        save = os.path.join(tmp, "save")
        save_config(cfg, save)
        ckpt = save_checkpoint(save, 0, 3, model, opt, LossLog(), ema)
        voc = make_synthetic_voc(os.path.join(tmp, "voc"), num_train=0,
                                 num_test=8, imsize=(512, 512), seed=2)
        res = {}
        for tag, extra in (("ema-eval", ["--model-load", save,
                                         "--ema-eval"]),
                           ("npz", ["--model-load",
                                    os.path.join(ckpt, "ema.npz")])):
            outdir = os.path.join(tmp, tag)
            t0 = time.time()
            main(["--data", voc, "--imsize", "512", "--batch-size", "8",
                  "--amp", "--serve-buckets", "8", "--serve-max-wait-ms",
                  "50", "--save-path", outdir] + extra)
            with open(os.path.join(outdir, "prediction_results.pickle"),
                      "rb") as f:
                res[tag] = (pickle.load(f), time.time() - t0)
        a, b = res["ema-eval"][0], res["npz"][0]
        same = sorted(a) == sorted(b) and all(
            all(np.array_equal(x, y) for x, y in zip(
                (a[k]["box"], a[k]["cls"], a[k]["score"]),
                (b[k]["box"], b[k]["cls"], b[k]["score"]))) for k in b)
        require(same, "--ema-eval detections differ from the EMA npz's")
        out["eval_s"] = res["ema-eval"][1]
    del model, opt, ema, step
    torch.cuda.empty_cache()
    log("train_extras ema: 3 steps, EMA vs host recurrence max abs %.3g; "
        "eval CLI --ema-eval on the checkpoint (8 images, %.1f s) equal to "
        "the EMA npz's detections" % (err, out["eval_s"]))
    return out


def extras_sentinel(state, arrs):
    """--sentinel, flagship --amp with an EMA: a NaN batch leaves every
    state tensor bit-identical and adds no host sync to the step (CUDA's
    sync debug mode, against the plain step); a finite spike above
    --sentinel-spike is skipped; the monitor's ladder over fetched flags
    (two windows with a skip halve the scale, a clean one doubles it)."""
    import torch
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.train import SentinelMonitor
    cfg = Config(batch_size=16, imsize=512, amp=True, sentinel=True,
                 ema_decay=0.99)
    plain_cfg = dataclasses.replace(cfg, sentinel=False)
    _, _, _, plain = extras_trainer(plain_cfg)
    plain(0, *arrs)
    plain_syncs, _ = syncs_in(lambda: plain(1, *arrs))
    monitor = SentinelMonitor(cfg)
    _, _, _, step = extras_trainer(cfg, monitor=monitor)
    step(0, *arrs)  # a clean step: moments, counts and the EMA move
    before = [t.clone() for t in step.sentinel.tensors()]
    nan = [torch.full_like(arrs[0], float("nan"))] + list(arrs[1:])
    syncs, losses = syncs_in(lambda: step(1, *nan))
    torch.cuda.synchronize()
    kept = all(torch.equal(a, b) for a, b in zip(before,
                                                  step.sentinel.tensors()))
    require(float(losses["sentinel_bad"]) == 1.0 and kept,
            "a NaN batch: skipped %s, every state tensor kept %s"
            % (float(losses["sentinel_bad"]), kept))
    require(syncs <= plain_syncs, "the sentinel step syncs %d times, the "
            "plain step %d" % (syncs, plain_syncs))
    _, _, _, spike = extras_trainer(dataclasses.replace(
        cfg, sentinel_spike=1e-3), monitor=monitor)
    before = [t.clone() for t in spike.sentinel.tensors()]
    sp = spike(0, *arrs)
    kept_spike = all(torch.equal(a, b) for a, b in zip(
        before, spike.sentinel.tensors()))
    require(float(sp["sentinel_bad"]) == 1.0 and kept_spike
            and math.isfinite(float(sp["total"])),
            "a spike (|g| %.4g > 1e-3) not skipped" % float(
                sp["sentinel_grad_norm"]))
    ladder = []
    for window in ([1.0, 0.0], [1.0], [0.0, 0.0]):
        monitor.observe([{"sentinel_bad": f} for f in window])
        ladder.append(monitor.scale)
    require(ladder == [0.5, 0.25, 0.5], "backoff ladder %s" % ladder)
    del step, spike, plain
    torch.cuda.empty_cache()
    out = dict(syncs=syncs, plain_syncs=plain_syncs, ladder=ladder,
               spike_grad_norm=float(sp["sentinel_grad_norm"]))
    log("train_extras sentinel: NaN batch skipped, every state tensor "
        "bit-identical; host syncs in the step %d (plain step %d); a finite "
        "spike (|g| %.4g > 1e-3) skipped; ladder %s" % (
            syncs, plain_syncs, out["spike_grad_norm"], ladder))
    return out


def extras_distill(state, arrs):
    """--distill: a teacher checkpoint the phase writes (the flagship with
    2 stacks, seeded, its snapshot beside), an edge-architecture student
    at b16 512^2 --amp: the teacher's eval kernels (#2, #8) launched as
    its predict derives on top of the student's train launches; the loss
    falls over 8 steps on one batch."""
    import torch
    from real_time_helmet_detection_tpu_torch.config import (Config,
                                                             save_config)
    from real_time_helmet_detection_tpu_torch.evaluate import init_weights
    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        build_model
    from real_time_helmet_detection_tpu_torch.ops.loss import LossLog
    from real_time_helmet_detection_tpu_torch.optim import build_optimizer
    from real_time_helmet_detection_tpu_torch.train import (make_distiller,
                                                            save_checkpoint)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_teacher_") as tmp:
        tcfg = Config(num_stack=2, imsize=512, batch_size=16)
        teacher = perturb_bn(init_weights(build_model(tcfg), 5), 5)
        save_config(tcfg, tmp)
        save_checkpoint(tmp, 0, 0, teacher, build_optimizer(
            tcfg, teacher.parameters()), LossLog())
        cfg = Config(batch_size=16, imsize=512, amp=True, distill=tmp,
                     distill_alpha=0.5, **VARIANT_CONFIGS["edge-arch"])
        distiller = make_distiller(cfg, "cuda")
    require(distiller.model.num_stack == 2, "teacher architecture not from "
            "its snapshot")
    _, _, _, step = extras_trainer(cfg, distiller=distiller)
    step(0, *arrs)
    counts, losses = launches_of(step, arrs, 1)
    want = expected_launches(cfg, "train", torch.bfloat16)
    teach = expected_launches(dataclasses.replace(tcfg, amp=True),
                              "predict", torch.bfloat16)
    for k in ("bn_act", "bn_act_vec", "bn_act_scalar", "bn_add_act"):
        want[k] += teach[k]
    require(counts == want, "--distill launches %s, want the student's "
            "train step + the teacher's predict %s" % (counts, want))
    totals = [float(step(i + 2, *arrs)["total"]) for i in range(8)]
    require(all(map(math.isfinite, totals)) and totals[-1] < totals[0],
            "--distill loss does not fall over 8 steps: %s" % totals)
    del step, distiller
    torch.cuda.empty_cache()
    out = dict(launches=counts, teacher_launches={
        k: teach[k] for k in ("bn_act", "bn_add_act")}, losses=totals,
        distill=float(losses["distill"]))
    log("train_extras distill: edge-arch student, 2-stack flagship teacher: "
        "#2/#5 %d (teacher %d), #8 %d (teacher %d) a step; soft loss %.4f; "
        "total over 8 steps %s" % (
            counts["bn_act"], teach["bn_act"], counts["bn_add_act"],
            teach["bn_add_act"], out["distill"],
            " ".join("%.3f" % v for v in totals)))
    return out


def extras_sentinel_subdiv(state, arrs):
    """--sentinel --sub-divisions 2 at the flagship's width, b16 512^2:
    4 micro-steps (the epoch's last flushes) with the 2nd poisoned. In
    f32 under cudnn.deterministic every state tensor (parameters,
    buffers, moments and counts, the EMA, the device window, the LR
    count) ends bit-equal to the same run with that micro-batch left
    out; at --amp the skip is flagged, the 4 micro-steps launch 4 train
    steps' kernels, and a step syncs the host no more than the plain
    `--sub-divisions 2` step."""
    import torch
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        synthetic_target_batch
    others = [[torch.from_numpy(a).cuda()
               for a in synthetic_target_batch(16, 512, seed=seed)]
              for seed in (1, 2)]
    poison = [torch.full_like(arrs[0], float("nan"))] + list(arrs[1:])
    seq = [arrs, poison] + others

    def run(cfg, batches, counted=False):
        _, _, _, step = extras_trainer(cfg)
        reset_counts()
        flags = [step(0, *b, update=i == len(batches) - 1)["sentinel_bad"]
                 for i, b in enumerate(batches)]
        torch.cuda.synchronize()
        counts = read_counts() if counted else None
        return step, [float(f) for f in flags], counts

    cfg32 = Config(batch_size=16, imsize=512, sentinel=True,
                   sub_divisions=2, ema_decay=0.99)
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        step, flags32, _ = run(cfg32, seq)
        skipped = [t.clone() for t in step.sentinel.tensors()]
        updates = float(step.sentinel.count)
        del step
        step, _, _ = run(cfg32, [seq[0]] + seq[2:])
        equal = [torch.equal(a, b)
                 for a, b in zip(skipped, step.sentinel.tensors())]
        del step
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    require(flags32 == [0.0, 1.0, 0.0, 0.0] and all(equal)
            and updates == 2.0,
            "--sentinel --sub-divisions 2 (f32): flags %s, %d of %d state "
            "tensors bit-equal to leaving the poisoned micro-batch out, "
            "%s updates (want 2: the window's and the flush's)"
            % (flags32, sum(equal), len(equal), updates))
    cfg = dataclasses.replace(cfg32, amp=True)
    step, flags, counts = run(cfg, seq, counted=True)
    want = {k: 4 * n for k, n in expected_launches(
        cfg, "train", torch.bfloat16).items()}
    require(flags == [0.0, 1.0, 0.0, 0.0] and counts == want,
            "--sentinel --sub-divisions 2 (--amp): flags %s, launches %s "
            "(want 4 steps' %s)" % (flags, counts, want))
    syncs, _ = syncs_in(lambda: step(0, *arrs))
    _, _, _, plain = extras_trainer(dataclasses.replace(
        cfg, sentinel=False))
    plain(0, *arrs, update=False)
    plain_syncs, _ = syncs_in(lambda: plain(1, *arrs, update=False))
    require(syncs <= plain_syncs, "the gated step syncs %d times, the "
            "plain --sub-divisions 2 step %d" % (syncs, plain_syncs))
    del step, plain
    torch.cuda.empty_cache()
    log("train_extras sentinel_subdiv: f32 %d state tensors bit-equal to "
        "the run without the poisoned micro-batch, 2 updates; --amp flags "
        "%s, launches 4 steps' (#4 %d, #12 %d), host syncs a step %d "
        "(plain --sub-divisions 2: %d)" % (
            len(equal), flags, counts["bn_stats"], counts["loss_fwd"],
            syncs, plain_syncs))
    return dict(launches=counts, syncs=syncs, plain_syncs=plain_syncs,
                tensors_equal=len(equal))


def extras_tier_throughput(state, arrs):
    """--tier throughput --train-flag: 3 steps of the tier's float
    architecture (ghost, 96 channels, stem 96) at b16 512^2 --amp, the
    launches as derived for it, the loss finite; its checkpoint evaluated
    at the tier: the int8 predict's launches as `expected_launches`
    derives (#16, #14, #15, #1) and its detections equal to those of a
    twin built from the same weights.npz."""
    import numpy as np
    import torch
    from real_time_helmet_detection_tpu_torch.config import (Config,
                                                             apply_tier)
    from real_time_helmet_detection_tpu_torch.convert import (load_into,
                                                              load_npz)
    from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state
    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        build_model
    from real_time_helmet_detection_tpu_torch.ops import quant
    from real_time_helmet_detection_tpu_torch.ops.loss import LossLog
    from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
    from real_time_helmet_detection_tpu_torch.train import save_checkpoint
    cfg = apply_tier(Config(tier="throughput", train_flag=True,
                            batch_size=16, imsize=512, amp=True))
    require((cfg.variant, cfg.hourglass_inch, cfg.stem_width,
             cfg.infer_dtype) == ("ghost", 96, 96, "int8"),
            "--tier throughput: %s" % cfg)
    model, opt, _, step = extras_trainer(cfg)
    step(0, *arrs)
    reset_counts()
    totals = [float(step(i + 1, *arrs)["total"]) for i in range(3)]
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: 3 * n for k, n in expected_launches(
        dataclasses.replace(cfg, infer_dtype="bf16"), "train",
        torch.bfloat16).items()}
    require(all(map(math.isfinite, totals)) and counts == want,
            "--tier throughput train: losses %s, launches %s, want %s"
            % (totals, counts, want))
    images = np.random.default_rng(7).integers(
        0, 256, (16, 512, 512, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tier_") as tmp:
        ckpt = save_checkpoint(tmp, 0, 4, model, opt, LossLog())
        del model, opt, step
        ecfg = apply_tier(Config(tier="throughput", batch_size=16,
                                 imsize=512, amp=True, model_load=ckpt))
        emodel = load_eval_state(ecfg)
        scales = quant.calibrate_scales(
            ecfg, emodel.state_dict(), quant.synthetic_calibration_batches(
                16, 512, n=2, raw=True, seed=7),
            dtype=emodel.dtype, normalize="imagenet")
        predict = make_predict_fn(emodel, ecfg, normalize="imagenet",
                                  quant_scales=scales)
        predict(images)
        reset_counts()
        dets = predict(images)
        torch.cuda.synchronize()
        ecounts = read_counts()
        twin_src = build_model(ecfg, dtype=torch.bfloat16)
        load_into(twin_src, load_npz(os.path.join(ckpt, "weights.npz")))
        direct = make_predict_fn(twin_src, ecfg, normalize="imagenet",
                                 quant_scales=scales)(images)
    ewant = expected_launches(ecfg, "predict", torch.bfloat16)
    same = all(torch.equal(a, b) for a, b in zip(dets, direct))
    require(ecounts == ewant and same,
            "--tier throughput eval of the trained checkpoint: launches %s "
            "(want %s), detections equal to the npz's twin %s"
            % (ecounts, ewant, same))
    del emodel, predict, twin_src
    torch.cuda.empty_cache()
    log("train_extras tier_throughput: ghost-96 --amp, 3 steps, total "
        "%s; #4 %d, #8 %d, #12 %d; eval at the tier: #16 %d, #14 %d, #15 "
        "%d, #1 %d a predict, detections equal to the npz's twin (%d "
        "valid)" % (" ".join("%.3f" % v for v in totals),
                    counts["bn_stats"], counts["bn_add_act"],
                    counts["loss_fwd"], ecounts["quantize_act"],
                    ecounts["qconv_dense"], ecounts["qconv_dw"],
                    ecounts["peak_scores"], int(dets.valid.sum())))
    return dict(train_launches=counts, eval_launches=ecounts, losses=totals)


def phase_train_extras(state):
    """The train-step extras at the flagship's width, b16 512^2 (the
    port's synthetic_target_batch): --fwd-dtype int8 (#14-#16 in
    training), --param-policy bf16-compute, --remat stacks|full, the EMA
    and --ema-eval, --sentinel, --distill (see each extras_* helper)."""
    import torch
    arrs = train_batch()
    out = {}
    for name, fn in (("int8", extras_int8), ("remat", extras_remat),
                     ("ema", extras_ema), ("sentinel", extras_sentinel),
                     ("distill", extras_distill), ("policy", extras_policy),
                     ("sentinel_subdiv", extras_sentinel_subdiv),
                     ("tier_throughput", extras_tier_throughput)):
        t0 = time.time()
        out[name] = fn(state, arrs)
        log("train_extras %s: %.1f s" % (name, time.time() - t0))
    state["train_extras"] = out
    state.setdefault("launches", {})["train_int8"] = out["int8"]["launches"]
    del arrs
    torch.cuda.empty_cache()


# ------------------------------------------------------- variant phases


def variant_cfg(name, **kw):
    """The port's Config of one of VARIANT_CONFIGS / SMALL_CONFIGS."""
    from real_time_helmet_detection_tpu_torch.config import Config
    fields = VARIANT_CONFIGS.get(name, SMALL_CONFIGS.get(name))
    return Config(**dict(fields, **kw))


def predict_against_plain(label, cfg, images, seed, match_both_ways=False):
    """One predict of cfg's model (seeded weights, random BN state) on the
    card: the launch counts of the run against `expected_launches`, the
    Detections' shape, the logits of the batch (shape, finite) and the
    Detections against the same path with every kernel swapped for its
    plain version: logits within 1e-4 (f32) or 2e-2 (bf16), and bit-equal
    with Detections identical where no site takes Mish (whose kernel
    holds rtol 1e-6 / one bf16 ulp to its plain version); where a site
    takes Mish, or `match_both_ways`, every detection >= 0.1 matched both
    ways (`detections_match`). Returns (model, predict, record)."""
    import torch
    from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state
    from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
    dtype = torch.bfloat16 if cfg.amp else torch.float32
    model = perturb_bn(load_eval_state(cfg), seed=seed)
    predict = make_predict_fn(model, cfg, normalize="imagenet")
    predict(images)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    reset_counts()
    dets = predict(images)  # THE run the counts read
    torch.cuda.synchronize()
    counts = read_counts()
    want = expected_launches(cfg, "predict", dtype)
    require(counts == want, "%s launches per forward %s, want %s"
            % (label, counts, want))
    n = cfg.num_stack * cfg.topk
    require(tuple(dets.boxes.shape) == (len(images), n, 4)
            and bool(torch.isfinite(dets.boxes).all())
            and bool(torch.isfinite(dets.scores).all()),
            "%s detections malformed" % label)
    lk, lp = full_batch_logits(model, images)
    side = cfg.imsize // (2 if cfg.pool in ("SPP", "None") else 4)
    require(bool(torch.isfinite(lk).all()) and tuple(lk.shape) == (
        len(images), cfg.num_stack, side, side, cfg.num_cls + 4),
        "%s logits malformed: %s" % (label, tuple(lk.shape)))
    with plain_kernels():
        dets_plain = predict(images)
    bit_equal = torch.equal(lk, lp)
    identical = all(torch.equal(a, b) for a, b in zip(dets, dets_plain))
    lerr = float((lk - lp).abs().max())
    tol = 1e-4 if not cfg.amp else 2e-2
    require(bool(torch.allclose(lk, lp, rtol=tol, atol=tol)),
            "%s logits kernel vs plain: max abs err %g > tol %g"
            % (label, lerr, tol))
    mish = "Mish" in (cfg.activation, cfg.neck_activation)
    if not mish:
        require(bit_equal and identical, "%s kernels vs plain: logits "
                "bit-equal %s (max abs err %g), Detections identical %s"
                % (label, bit_equal, lerr, identical))
    checked = None
    if mish or match_both_ways:
        checked = detections_match(dets, dets_plain) \
            + detections_match(dets_plain, dets)
    record = dict(counts=counts, bit_equal=bit_equal,
                  identical=identical, logit_err=lerr, tol=tol,
                  checked=checked, valid=int(dets.valid.sum()),
                  logit_max=float(lk.abs().max()))
    del lk, lp
    return model, predict, record


def phase_variants(state):
    """Predict at b16 512^2, f32 and bf16, for each of VARIANT_CONFIGS
    (`predict_against_plain`), then its peak memory, images/s (3
    alternating windows of ~0.5 s and at least 3 predicts, kernels and
    plain) and, from a torch.profiler trace of one predict, device busy
    time by kernel group and the idle share against the untraced wall;
    then the stem conv direct and in its space-to-depth form side by side,
    and the SPP pools' cascade against the direct pools (bit-equal)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from real_time_helmet_detection_tpu_torch.models import hourglass
    images = np.random.default_rng(0).integers(
        0, 256, (16, 512, 512, 3), dtype=np.uint8)
    out = state.setdefault("variants", {})
    for name in VARIANT_CONFIGS:
        for amp in (False, True):
            tag = "bf16" if amp else "f32"
            label = "variants %s %s" % (name, tag)
            cfg = variant_cfg(name, batch_size=16, imsize=512, amp=amp)
            model, predict, rec = predict_against_plain(label, cfg, images,
                                                        seed=3)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            predict(images)
            torch.cuda.synchronize()
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            rates = throughput(predict, images, windows=3, window_s=0.5,
                               min_predicts=3)
            wall = rates["kernels"]["ms_per_predict"]
            by_name, traced = trace_device_ms(lambda i: predict(images),
                                              reps=1)
            busy = sum(by_name.values())
            groups = group_device_ms(by_name, (
                "bn_add_act_kernel", "bn_act_vec_kernel", "bn_act_kernel",
                "peak_kernel"))
            rec.update(rates=rates, busy_ms=busy, traced_ms=traced,
                       idle=max(0.0, 1 - busy / wall) if busy else None,
                       groups=groups)
            out[(name, tag)] = rec
            epi = {k: v for k, v in rec["counts"].items() if v}
            log("%s: launches %s; logits (16 images) kernel vs plain "
                "bit-equal %s (max abs err %g, |logit| max %.3g), Detections "
                "identical %s%s; %d valid after NMS; peak memory %.2f GB" % (
                    label, epi, rec["bit_equal"],
                    rec["logit_err"], rec["logit_max"], rec["identical"],
                    "" if rec["checked"] is None else
                    ", %d detections >= 0.1 matched both ways"
                    % rec["checked"], rec["valid"], rec["peak_gb"]))
            for path, r in rates.items():
                log("%s: predict b16 512^2 with %s: median %.1f img/s "
                    "(%.2f ms per predict), min %.1f, max %.1f over %d "
                    "windows of %d predicts" % (
                        label, path, r["median_ips"], r["ms_per_predict"],
                        min(r["ips"]), max(r["ips"]), len(r["ips"]),
                        r["predicts_per_window"]))
            if busy:
                log_profile("%s (ms per predict, wall from the kernel "
                            "windows)" % label, wall, traced, by_name,
                            groups, top=4)
            else:
                log("%s: the profiler saw no device time; idle share not "
                    "measured" % label)
            del model, predict
            torch.cuda.empty_cache()
    # the stem, direct and space-to-depth, at the main path's input
    gen = torch.Generator(device="cuda").manual_seed(9)
    stem = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        conv = torch.nn.Conv2d(3, 64, 7, 2, 3).cuda().to(dtype).to(
            memory_format=torch.channels_last)
        x = channels_last(rand((16, 3, 512, 512), dtype, gen))
        with torch.no_grad():
            direct = hourglass.conv2d(x, conv)
            s2d = hourglass.stem_s2d_conv(x, conv)
            times = {"direct": [], "s2d": []}
            for form in ("direct", "s2d", "s2d", "direct"):
                fn = hourglass.conv2d if form == "direct" \
                    else hourglass.stem_s2d_conv
                times[form].append(graph_ms(lambda: fn(x, conv)))
        stem[tag] = dict({k: sum(v) / len(v) for k, v in times.items()},
                         max_abs=float((direct.float() - s2d.float())
                                       .abs().max()),
                         scale=float(direct.float().abs().max()))
        log("variants stem %s (16, 3, 512, 512) -> 64 ch, by CUDA graph "
            "replay in turns: direct 7x7/2 %.4f ms, space-to-depth 4x4/1 "
            "%.4f ms (its layout copies included); outputs differ by %.3g "
            "(|out| max %.3g)" % (tag, stem[tag]["direct"], stem[tag]["s2d"],
                                  stem[tag]["max_abs"], stem[tag]["scale"]))
        require(stem[tag]["max_abs"] <= (1e-4 if tag == "f32" else 5e-2)
                * max(1.0, stem[tag]["scale"]),
                "stem %s: the s2d form disagrees with the direct conv" % tag)
    state["stem"] = stem
    # the SPP pools as the model takes them (5 x 5 pools of the one
    # before) against the direct 5/9/13 pools, at the neck's input
    for dtype in (torch.float32, torch.bfloat16):
        x = channels_last(rand((16, 64, 128, 128), dtype, gen))
        direct = [F.max_pool2d(x, k, 1, (k - 1) // 2) for k in (5, 9, 13)]
        require(all(torch.equal(a, b) for a, b in
                    zip(direct, hourglass.spp_pools(x)[1:])),
                "SPP pools %s: the cascade differs from the direct pools"
                % dtype)
    log("variants SPP pools (16, 64, 128, 128), f32 and bf16: the cascade "
        "is bit-equal to the direct pools")


def phase_variants_small(state):
    """The options outside VARIANT_CONFIGS (SMALL_CONFIGS: the Avg and SPP
    pools, LReLU, Sigmoid, CELU (also the neck's), Mish and maxpool NMS)
    at batch 4, 128^2, width 32, f32 and bf16, through the kernels against
    the plain versions on the card, each with its launch counts
    (`predict_against_plain`)."""
    import numpy as np
    import torch
    images = np.random.default_rng(2).integers(
        0, 256, (4, 128, 128, 3), dtype=np.uint8)
    out = state.setdefault("variants_small", {})
    for name in SMALL_CONFIGS:
        for amp in (False, True):
            tag = "bf16" if amp else "f32"
            label = "variants_small %s %s" % (name, tag)
            cfg = variant_cfg(name, batch_size=4, imsize=128,
                              hourglass_inch=32, amp=amp)
            model, predict, rec = predict_against_plain(label, cfg, images,
                                                        seed=6)
            out[(name, tag)] = rec
            del model, predict
    log("variants_small: %d runs passed (b4 128^2, width 32): %s" % (
        len(out), "; ".join(
            "%s %s: bn_act %d, bn_add_act %d, bit-equal %s, identical %s, "
            "%d valid" % (n, t, r["counts"]["bn_act"],
                          r["counts"]["bn_add_act"], r["bit_equal"],
                          r["identical"], r["valid"])
            for (n, t), r in out.items())))
    torch.cuda.empty_cache()


def eval_grad_against_plain(label, cfg, arrs):
    """The eval-mode model (seeded weights, random BN state; bf16 weights
    under cfg.amp), the fused loss and backward(), through the kernels and
    through the plain versions (cudnn.deterministic): launch counts of the
    kernel run against `expected_launches`, every parameter non-zero
    (PReLU slopes among them); in f32, loss and gradient rel L2 kernels
    vs plain within 1e-5. Returns both runs' losses and gradients and
    their errors."""
    import torch
    from real_time_helmet_detection_tpu_torch.evaluate import init_weights
    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        build_model
    from real_time_helmet_detection_tpu_torch.ops.loss import \
        fused_detection_loss
    dtype = torch.bfloat16 if cfg.amp else torch.float32
    model = build_model(cfg, dtype=torch.bfloat16 if cfg.amp else None)
    model = perturb_bn(init_weights(model, 0), seed=5).cuda().eval()

    def backward():
        model.zero_grad(set_to_none=True)
        total = fused_detection_loss(model(arrs[0]), *arrs[1:])["total"]
        total.backward()
        torch.cuda.synchronize()
        return total.item(), {n: p.grad.detach().clone()
                              for n, p in model.named_parameters()}

    torch.backends.cudnn.deterministic = True
    try:
        backward()  # warm-up: cuDNN plans, allocator
        reset_counts()
        lk, gk = backward()  # THE eval-grad run the counts read
        counts = read_counts()
        with plain_kernels():
            lp, gp = backward()
    finally:
        torch.backends.cudnn.deterministic = False
    want = expected_launches(cfg, "eval_grad", dtype)
    require(counts == want, "%s launches per eval backward %s, want %s"
            % (label, counts, want))
    zero = [n for n, g in gk.items() if float(g.abs().max()) == 0.0]
    require(not zero and len(gk) == len(list(model.parameters())),
            "%s eval backward left parameters without a gradient: %s"
            % (label, zero))
    e = dict(loss=lk, plain_loss=lp, grads=gk, plain_grads=gp,
             loss_err=abs(lk - lp) / abs(lp), grad_err=rel_l2(gk, gp),
             slopes=sum(n.endswith("negative_slope") for n in gk),
             params=len(gk), counts=counts)
    log("%s: launches %s; all %d parameters have a non-zero gradient (%d "
        "PReLU slopes); loss %.7f vs %.7f plain, gradient rel L2 kernels vs "
        "plain %.3g%s" % (
            label, {k: v for k, v in counts.items() if v}, e["params"],
            e["slopes"], lk, lp, e["grad_err"],
            "" if cfg.amp else " (tol 1e-5)"))
    require(cfg.amp or (e["grad_err"] <= 1e-5 and e["loss_err"] <= 1e-5),
            "%s eval gradient kernels vs plain beyond tolerance: loss %g, "
            "gradient %g" % (label, e["loss_err"], e["grad_err"]))
    del model
    torch.cuda.empty_cache()
    return e


def phase_variants_train(state):
    """The --amp train step at b16 512^2 for edge-arch and depthwise-128
    (seeded weights, the port's synthetic_target_batch): launch counts of
    one step against `expected_launches`, the step against its
    plain-version twin under train_main's rule (STEP_TOL, f32 and bf16),
    the loss over 8 steps on one batch, images/s (3 alternating windows
    of ~0.5 s), peak memory; then one eval-mode gradient (f32) each for
    edge-arch and options (PReLU slopes), as eval_grad takes one."""
    import statistics
    import torch
    arrs = train_batch()
    out = state.setdefault("variants_train", {})
    for name in ("edge-arch", "depthwise-128"):
        label = "variants_train %s" % name
        cfg = variant_cfg(name, batch_size=16, imsize=512, amp=True)
        model, opt, _, step = extras_trainer(cfg)
        saved = {k: v.clone() for k, v in model.state_dict().items()}
        saved_opt = opt.state_dict()
        step(0, *arrs)  # warm-up on a throwaway copy of the weights
        torch.cuda.synchronize()
        model.load_state_dict(saved)
        opt.load_state_dict(saved_opt)
        cfg32 = variant_cfg(name, batch_size=16, imsize=512)
        model32 = extras_trainer(cfg32)[0]
        model32.load_state_dict(model.state_dict())
        log("%s: the step against its plain-version twin:" % label)
        errs = check_train_step(model, model32, arrs, cfg, cfg32)
        del model32
        reset_counts()
        step(0, *arrs)  # THE train-path run the counts read
        torch.cuda.synchronize()
        counts = read_counts()
        want = expected_launches(cfg, "train", torch.bfloat16)
        require(counts == want, "%s launches per train step %s, want %s"
                % (label, counts, want))
        losses = [float(step(i + 1, *arrs)["total"]) for i in range(8)]
        require(all(map(math.isfinite, losses))
                and statistics.mean(losses[-3:]) < statistics.mean(losses[:3])
                and losses[-1] < losses[0],
                "%s loss does not fall over 8 steps on one batch: %s"
                % (label, losses))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(9, *arrs)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rates = train_throughput(step, arrs, windows=3, window_s=0.5)
        out[name] = dict(counts=counts, errs=errs, losses=losses,
                         peak_gb=peak_gb, rates=rates)
        log("%s bf16: launches %s per step; loss over 8 steps %.4f -> %.4f; "
            "peak memory %.2f GB" % (
                label, {k: v for k, v in counts.items() if v}, losses[0],
                losses[-1], peak_gb))
        for path, r in rates.items():
            log("%s bf16: train step b16 512^2 with %s: median %.1f img/s "
                "(%.2f ms per step), min %.1f, max %.1f over %d windows of "
                "%d steps" % (label, path, r["median_ips"], r["ms_per_step"],
                              min(r["ips"]), max(r["ips"]), len(r["ips"]),
                              r["steps_per_window"]))
        del model, opt, step
        torch.cuda.empty_cache()
    for name in ("edge-arch", "options"):
        e = eval_grad_against_plain(
            "variants_train eval_grad %s f32" % name,
            variant_cfg(name, batch_size=16, imsize=512), arrs)
        out["eval_grad " + name] = {k: v for k, v in e.items()
                                    if k not in ("grads", "plain_grads")}


def nms_time_ms(fn, reps=5):
    """Median host wall of one synchronised fn() call, in ms."""
    import statistics
    import torch
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[1:])


def clustered_boxes(seed, n=200, clusters=24, jitter=10.0, extent=512.0):
    """(boxes (n, 4), scores (n,)) of seeded clustered, overlapping boxes,
    as the JAX package's own NMS tests make them (ref
    tests/test_nms.py:184), 20-70 px wide around `clusters` centres."""
    import numpy as np
    rng = np.random.RandomState(seed)
    centers = rng.uniform(60, extent - 60, (clusters, 2))
    xy = centers[rng.randint(0, clusters, n)] + rng.uniform(
        -jitter, jitter, (n, 2))
    wh = rng.uniform(20, 70, (n, 2))
    boxes = np.clip(np.concatenate([xy - wh / 2, xy + wh / 2], 1),
                    0, extent).astype(np.float32)
    return boxes, rng.uniform(0.1, 1.0, n).astype(np.float32)


def phase_nms(state):
    """Hard, soft and maxpool NMS on the card against the same functions
    on the CPU: on 16 sets of 200 seeded clustered boxes (a tenth
    invalid), where each mode must keep some boxes and drop others and
    soft-NMS must decay scores (score floor 0.3, as the JAX package's
    soft-NMS oracle test); and on the decoded boxes of a quality-arch
    predict (b16 512^2, bf16, 200 boxes an image), whose host wall per
    b16 batch is recorded. Keep masks identical, soft-NMS's decayed
    scores within 1e-6."""
    import numpy as np
    import torch
    from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state
    from real_time_helmet_detection_tpu_torch.ops import decode, nms, peak
    from real_time_helmet_detection_tpu_torch.utils import normalizer_stats
    cfg = variant_cfg("quality-arch", batch_size=16, imsize=512, amp=True)

    def modes(score_th):
        return {
            "nms": lambda *a: (nms.nms_mask(*a, cfg.nms_th), a[1]),
            "soft-nms": lambda *a: nms.soft_nms_mask(*a, score_th=score_th),
            "maxpool": lambda *a: (nms.maxpool_nms_mask(
                *a, extent=float(cfg.imsize)), a[1]),
        }

    def card_vs_cpu(what, mode, fn, card):
        cpu = [t.cpu() for t in card]
        kg, sg = fn(*card)
        kc, sc = fn(*cpu)
        same = torch.equal(kg.cpu(), kc)
        err = float((sg.cpu() - sc).abs().max())
        require(same and err <= 1e-6, "nms %s on %s: the card disagrees "
                "with the CPU (identical %s, score err %g)"
                % (mode, what, same, err))
        return kg, sg, same, err

    sets = [clustered_boxes(seed) for seed in range(16)]
    card = [torch.from_numpy(np.stack([b for b, _ in sets])).cuda(),
            torch.from_numpy(np.stack([c for _, c in sets])).cuda(),
            torch.from_numpy(np.random.RandomState(0).rand(16, 200) >= 0.1)
            .cuda()]
    n_valid = int(card[2].sum())
    rec = state.setdefault("nms", {})
    for mode, fn in modes(0.3).items():
        kg, sg, same, err = card_vs_cpu("clustered boxes", mode, fn, card)
        kept = int(kg.sum())
        decayed = int(((sg != card[1]) & card[2]).sum())
        rec["clustered " + mode] = dict(kept=kept, decayed=decayed)
        log("nms %s on 16 x 200 seeded clustered boxes (%d valid): keep "
            "masks card vs CPU identical %s (%d kept), %d scores decayed, "
            "scores max abs diff %.3g" % (mode, n_valid, same, kept,
                                          decayed, err))
        require(0 < kept < n_valid, "nms %s on clustered boxes keeps %d of "
                "%d: the comparison tests nothing" % (mode, kept, n_valid))
        require(mode != "soft-nms" or decayed > 0,
                "soft-nms decayed no score on clustered boxes")

    model = perturb_bn(load_eval_state(cfg), seed=3)
    images = np.random.default_rng(0).integers(
        0, 256, (16, 512, 512, 3), dtype=np.uint8)
    mean, std = (torch.as_tensor(s, device="cuda")
                 for s in normalizer_stats("imagenet"))
    x = (torch.as_tensor(images).cuda().float() / 255.0 - mean) / std
    with torch.inference_mode():
        out = model(x)
        dets = decode.decode_peak_scores(
            peak.peak_scores(out, 2, 3), out[..., 2:4], out[..., 4:6],
            topk=cfg.topk, conf_th=cfg.conf_th)
    b = out.shape[0]
    card = [dets.boxes.reshape(b, -1, 4), dets.scores.reshape(b, -1),
            dets.valid.reshape(b, -1)]
    cpu = [t.cpu() for t in card]
    for mode, fn in modes(cfg.conf_th).items():
        kg, _, same, err = card_vs_cpu("a quality-arch predict", mode, fn,
                                       card)
        ms = nms_time_ms(lambda: fn(*card))
        cpu_ms = nms_time_ms(lambda: fn(*cpu))
        rec[mode] = dict(same=same, score_err=err, ms=ms, cpu_ms=cpu_ms,
                         kept=int(kg.sum()))
        log("nms %s on (16, %d) boxes of a quality-arch predict: keep masks "
            "card vs CPU identical %s (%d kept), scores max abs diff %.3g; "
            "%.2f ms per b16 batch on the card (host wall, synchronised), "
            "%.2f ms on the CPU" % (mode, card[0].shape[1], same,
                                    rec[mode]["kept"], err, ms, cpu_ms))
    del model, out, x
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- serving

SERVE_BUCKETS = (1, 2, 4, 8, 16)
# a kernel's name in a profiler trace -> its launch counter
TRACE_KERNELS = (("bn_act_vec_kernel", "bn_act_vec"),
                 ("bn_add_act_kernel", "bn_add_act"),
                 ("bn_act_kernel", "bn_act_scalar"),
                 ("peak_kernel<true>", "peak_vec"),
                 ("peak_kernel<false>", "peak_scalar"),
                 ("bn_stats_kernel", "bn_stats"),
                 ("bn_bwd_sums_kernel", "bn_bwd_sums"),
                 ("bn_bwd_dx_kernel", "bn_bwd_dx"),
                 ("loss_fwd_kernel", "loss_fwd"),
                 ("loss_bwd", "loss_bwd"),
                 ("qconv_wgmma_kernel", "qconv_dense_wgmma"),
                 ("qconv_dense_kernel", "qconv_dense_mma"),
                 ("qconv_dw_tile_kernel", "qconv_dw_tiled"),
                 ("qconv_dw_kernel", "qconv_dw_gather"),
                 ("quantize_kernel", "quantize_act"),
                 ("absmax_kernel", "abs_max"))


def graph_nodes(graph):
    """Nodes of a captured CUDA graph (`cuGraphGetNodes` on the kept
    cudaGraph_t, through libcuda), or None where that call fails."""
    import ctypes
    try:
        raw = graph.raw_cuda_graph()
        count = ctypes.c_size_t(0)
        err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
            ctypes.c_void_p(raw), None, ctypes.byref(count))
    except (AttributeError, OSError, RuntimeError):
        return None
    return int(count.value) if err == 0 else None


def graph_kernel_nodes(graph):
    """Kernel nodes of a captured CUDA graph (`cuGraphGetNodes` and
    `cuGraphNodeGetType` through libcuda), or None where a call fails."""
    import ctypes
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        raw = ctypes.c_void_p(graph.raw_cuda_graph())
        count = ctypes.c_size_t(0)
        if lib.cuGraphGetNodes(raw, None, ctypes.byref(count)):
            return None
        nodes = (ctypes.c_void_p * count.value)()
        if lib.cuGraphGetNodes(raw, nodes, ctypes.byref(count)):
            return None
        kind, kernels = ctypes.c_int(0), 0
        for node in nodes[:count.value]:
            if lib.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)):
                return None
            kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    except (AttributeError, OSError, RuntimeError):
        return None
    return kernels


def step_trace(run, before_active=None):
    """Device operations by name in one `run()`, from a torch.profiler
    trace whose schedule calls it once as the profiler's warm-up step
    (recorded, then discarded) and once as the active step that is
    counted; `before_active()` runs just before that second call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    names = {}

    def ready(prof):
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                names[ev.key] = names.get(ev.key, 0) + ev.count

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as prof:
        for step in range(2):
            if step and before_active is not None:
                before_active()
            run()
            torch.cuda.synchronize()
            prof.step()
    return names


def replay_trace(graph):
    """Device operations by name in one replay of `graph` (`step_trace`),
    the recorded replay opened by 10 ms of host time, so that its first
    kernels are not at the recorded window's first instant (as
    `copies_of`'s steps)."""
    return step_trace(graph.replay, before_active=lambda: time.sleep(0.01))


def replay_launches(runner, attempts=5):
    """Our kernels' launches in one replay of a bucket's graph, counted by
    kernel name in a torch.profiler trace of it (`replay_trace`), as
    launch counters (bn_act = vector + scalar, peak_scores = vector +
    scalar, the int8 convs the sums of their two kernels each). A trace
    that holds fewer kernels than the graph has kernel nodes
    (`graph_kernel_nodes`; none at all where that count fails) missed
    part of the replay (the profiler has done so) and is taken again, up
    to `attempts` times; the counts of the last trace are what the
    caller checks."""
    need = graph_kernel_nodes(runner.graph)
    for attempt in range(attempts):
        names = replay_trace(runner.graph)
        seen = sum(n for name, n in names.items()
                   if not name.startswith(("Memcpy", "Memset")))
        if seen >= (need or 1):
            break
        log("  a replay trace held %d kernels of the graph's %s kernel "
            "nodes (attempt %d of %d)" % (seen, need, attempt + 1,
                                          attempts))
    return kernel_counts(names)


def kernel_counts(names):
    """{kernel name in a trace: launches} -> our kernels' launches as
    launch counters (bn_act = vector + scalar, peak_scores = vector +
    scalar, the int8 convs the sums of their two kernels each)."""
    got = {}
    for name, n in names.items():
        hit = next((c for key, c in TRACE_KERNELS if key in name), None)
        if hit:
            got[hit] = got.get(hit, 0) + int(round(n))
    got["bn_act"] = got.get("bn_act_vec", 0) + got.get("bn_act_scalar", 0)
    got["peak_scores"] = got.get("peak_vec", 0) + got.get("peak_scalar", 0)
    got["qconv_dense"] = (got.get("qconv_dense_wgmma", 0)
                          + got.get("qconv_dense_mma", 0))
    got["qconv_dw"] = got.get("qconv_dw_tiled", 0) + got.get("qconv_dw_gather",
                                                            0)
    return got


def want_replay(cfg, dtype):
    """`expected_launches` of one predict, on the counters a trace can
    tell apart."""
    want = expected_launches(cfg, "predict", dtype)
    keys = {c for _, c in TRACE_KERNELS} | {"bn_act", "peak_scores",
                                            "qconv_dense", "qconv_dw"}
    return {k: want[k] for k in sorted(keys)}


def served_logits(model, images):
    """The model's logits on the normalized uint8 batch, as the serving
    path computes them."""
    import torch
    from real_time_helmet_detection_tpu_torch.utils import normalizer_stats
    mean, std = (torch.as_tensor(s, device="cuda")
                 for s in normalizer_stats("imagenet"))
    with torch.inference_mode():
        return model((torch.as_tensor(images).cuda().float() / 255.0
                      - mean) / std)


def np_rows(rows):
    """Engine rows (numpy Detections) -> one torch Detections batch."""
    import numpy as np
    import torch
    from real_time_helmet_detection_tpu_torch.ops.decode import Detections
    return Detections(*(torch.from_numpy(np.stack(leaf)) for leaf in
                        zip(*rows)))


def rows_equal(a, b):
    import numpy as np
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def serve_group(engine, images):
    """Submit `images` at once and wait: with the engine's max wait they
    form one batch. Returns the rows; requires that one batch of the
    matching bucket served them."""
    before = engine.stats()["batches"]
    futs = [engine.submit(img) for img in images]
    rows = [f.result(timeout=120) for f in futs]
    require(engine.stats()["batches"] == before + 1
            and all(f.bucket == len(images) for f in futs),
            "serve: %d requests did not form one bucket-%d batch"
            % (len(images), len(images)))
    return rows


def closed_loop(engine, images, seconds, clients=64):
    """Images/s of a saturated closed loop (`serving.loadgen.closed_loop`):
    `clients` clients, each submitting its next request as its last
    completes, for about `seconds`."""
    from real_time_helmet_detection_tpu_torch.serving import loadgen
    return loadgen.closed_loop(engine, images, clients,
                               seconds)["goodput_rps"]


def serial_latency_ms(engine, images, seconds):
    """(p50, p99) latency in ms, submit to result, of a serial stream: one
    client of `serving.loadgen.closed_loop` for about `seconds`."""
    from real_time_helmet_detection_tpu_torch.serving import loadgen
    r = loadgen.closed_loop(engine, images, 1, seconds)
    return r["p50_ms"], r["p99_ms"]


def serve_engine(predict, images, buckets, **kw):
    """A serving engine of `predict` on the uint8 wire of `images`' shape,
    with its own metrics registry and no span log."""
    import numpy as np
    from real_time_helmet_detection_tpu_torch.obs.metrics import \
        MetricsRegistry
    from real_time_helmet_detection_tpu_torch.obs.spans import SpanTracer
    from real_time_helmet_detection_tpu_torch.serving import ServingEngine
    return ServingEngine(predict, None, images.shape[1:], np.uint8,
                         buckets=buckets, tracer=SpanTracer(None),
                         metrics=MetricsRegistry(), **kw)


def serve_config(label, cfg, images, seed, full):
    """One configuration through the serving engine (buckets from the
    config, 20 ms max wait, depth 2): one graph per bucket (capture time,
    nodes), launches of each bucket's replay from the profiler against
    `expected_launches`, each bucket's rows bit-equal to the eager predict
    at its batch size; across buckets (against the largest), f32 rows
    matched both ways under phase main's rule; bf16 logits of two batch
    sizes no further apart than bf16 is from f32 on the same images
    (cuDNN takes other bf16 algorithms at other batch sizes), the matches
    counted;
    images/s of a saturated closed loop, and the serial bucket-1 latency
    (an engine of bucket 1, no wait). `full` (the flagship) adds the
    chaos retries, the hot reload, three throughput windows against eager
    windows, p99 and the idle share."""
    import numpy as np
    import torch
    from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state
    from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
    from real_time_helmet_detection_tpu_torch.runtime import (
        ChaosInjector, FaultEvent, FaultSchedule)
    from real_time_helmet_detection_tpu_torch.serving import \
        resolve_buckets
    dtype = torch.bfloat16 if cfg.amp else torch.float32
    buckets = resolve_buckets(cfg)
    top = buckets[-1]
    l_twin = None
    if cfg.amp:  # the f32 twin's logits: same seeds, TF32 off
        twin = perturb_bn(load_eval_state(dataclasses.replace(cfg,
                                                              amp=False)),
                          seed=seed)
        l_twin = served_logits(twin, images[:top])
        del twin
        torch.cuda.empty_cache()
    model = perturb_bn(load_eval_state(cfg), seed=seed)
    predict = make_predict_fn(model, cfg, normalize="imagenet")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = serve_engine(predict, images, buckets, max_wait_ms=20.0, depth=2)
    build_s = time.perf_counter() - t0
    rec = dict(build_s=build_s, buckets={},
               graph_gb=(torch.cuda.memory_allocated() - mem0) / 1e9)
    want = want_replay(cfg, dtype)
    rows, eager = {}, {}
    t_trace = 0.0
    for b in buckets:
        runner = engine.runners[b]
        t0 = time.perf_counter()
        got = replay_launches(runner)
        t_trace += time.perf_counter() - t0
        got = {k: got.get(k, 0) for k in want}
        require(got == want, "%s bucket %d: launches per replay %s, want %s"
                % (label, b, got, want))
        rows[b] = serve_group(engine, images[:b])
        eager[b] = [tuple(t[i].cpu().numpy() for t in predict(images[:b]))
                    for i in range(b)]
        same = [rows_equal(r, e) for r, e in zip(rows[b], eager[b])]
        require(all(same), "%s bucket %d: %d of %d rows differ from the "
                "eager predict at batch %d" % (label, b, same.count(False),
                                                b, b))
        rec["buckets"][b] = dict(capture_s=runner.build_s,
                                 nodes=graph_nodes(runner.graph))
    # across buckets: each smaller bucket's rows against the largest's;
    # f32 rows must match both ways (phase main's rule); in bf16, where
    # cuDNN's algorithm for another batch size rounds otherwise, the
    # logits of two batch sizes may be no further apart than bf16 is from
    # f32 on the same images (the f32 twin: same seeds, TF32 off), and
    # the matches are counted
    l_top = served_logits(model, images[:top])
    bound = None if l_twin is None else float((l_twin - l_top).abs().max())
    del l_twin
    checked, missed, differ, lerr = 0, 0, 0, 0.0
    for b in buckets[:-1]:
        pairs = ((np_rows(rows[b]), np_rows(rows[top][:b])),
                 (np_rows(rows[top][:b]), np_rows(rows[b])))
        for x, y in pairs:
            n, misses = match_misses(x, y)
            checked, missed = checked + n, missed + len(misses)
            require(cfg.amp or not misses, "%s bucket %d vs %d: %d of %d "
                    "detections have no match" % (label, b, top,
                                                   len(misses), n))
        differ += sum(not rows_equal(x, y)
                      for x, y in zip(rows[b], rows[top][:b]))
        err = float((served_logits(model, images[:b]) - l_top[:b])
                    .abs().max())
        lerr = max(lerr, err)
        if bound is not None:
            require(err <= bound, "%s bucket %d vs %d: bf16 logits differ "
                    "by %g, more than bf16 from f32 (%g)"
                    % (label, b, top, err, bound))
    rec["trace_s"] = t_trace
    rec.update(launches=want, matched=checked - missed, checked=checked,
               rows_differ=differ, rows_compared=sum(buckets[:-1]),
               logit_err=lerr, bf16_vs_f32=bound)
    if full:
        # (d) a dispatch fault, then a hung fetch (the watchdog at 0.5 s),
        # each retried through the same graph
        inj = ChaosInjector(FaultSchedule([
            FaultEvent("serve:dispatch", "device-loss", 1),
            FaultEvent("serve:fetch", "hung-fetch", 1, {"hang_s": 1.5})]))
        with serve_engine(predict, images, (4,), max_wait_ms=20.0, depth=2,
                          max_retries=2, hang_timeout_s=0.5,
                          injector=inj) as chaos:
            futs = [chaos.submit(img) for img in images[:4]]
            got = [f.result(timeout=120) for f in futs]
            st = chaos.stats()
        require(len(inj.fired) == 2 and st["hung_batches"] == 1
                and st["failed"] == 0 and st["retried"] >= 4
                and all(rows_equal(r, e) for r, e in zip(got, eager[4])),
                "%s chaos: fired %s, stats %s, rows bit-identical %s"
                % (label, [e.key for e in inj.fired], st,
                   [rows_equal(r, e) for r, e in zip(got, eager[4])]))
        rec["chaos"] = dict(fired=[e.key for e in inj.fired],
                            retried=st["retried"],
                            hung=st["hung_batches"])
        # (e) hot reload: weights of another BN state, copied in place
        ptrs = [t.data_ptr() for t in list(model.parameters())
                + list(model.buffers())]
        fresh = perturb_bn(load_eval_state(cfg), seed=seed + 2)
        engine.reload(fresh.state_dict())
        del fresh
        new_rows = serve_group(engine, images[:top])
        new_eager = [tuple(t[i].cpu().numpy() for t in
                           predict(images[:top])) for i in range(top)]
        same_ptrs = ptrs == [t.data_ptr() for t in list(model.parameters())
                             + list(model.buffers())]
        changed = sum(not rows_equal(a, b)
                      for a, b in zip(new_rows, rows[top]))
        require(same_ptrs and changed > 0 and all(
            rows_equal(a, b) for a, b in zip(new_rows, new_eager)),
            "%s reload: storages kept %s, rows changed %d, rows equal the "
            "eager predict of the new weights %s" % (
                label, same_ptrs, changed,
                [rows_equal(a, b) for a, b in zip(new_rows, new_eager)]))
        rec["reload"] = dict(changed=changed)
        # (f) saturated closed loop against eager predicts, in turns
        # (eager: predicts of the b16 batch queued back to back, one sync
        # at the window's end, as phase main times them)
        rates = {"engine": [], "eager": []}
        for _ in range(3):
            rates["engine"].append(closed_loop(engine, images, 1.0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = 0
            while time.perf_counter() - t0 < 1.0:
                predict(images)
                n += 1
            torch.cuda.synchronize()
            rates["eager"].append(n * len(images)
                                  / (time.perf_counter() - t0))
        rec["rates"] = rates
        # (h) the device's idle share over a saturated window
        by_name, traced = trace_device_ms(
            lambda i: closed_loop(engine, images, 0.5), reps=1)
        busy = sum(by_name.values())
        rec["idle"] = (max(0.0, 1 - busy / traced) if busy else None)
        rec["busy_ms"], rec["traced_ms"] = busy, traced
    else:
        rec["rates"] = {"engine": [closed_loop(engine, images, 1.0)]}
    require(engine.stats()["bucket_builds"] == len(buckets)
            and engine.stats()["failed"] == 0,
            "%s: bucket builds %d for %d buckets after serving"
            % (label, engine.stats()["bucket_builds"], len(buckets)))
    engine.close()
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del engine
    # (g) the serial bucket-1 stream, no wait
    with serve_engine(predict, images, (1,), max_wait_ms=0.0,
                      depth=2) as one:
        serial_latency_ms(one, images, 0.2)
        rec["p50_ms"], rec["p99_ms"] = serial_latency_ms(
            one, images, 1.5 if full else 0.6)
    del model, predict
    torch.cuda.empty_cache()
    return rec


def phase_serve(state):
    """The serving engine, the port's eval and demo predict path, at b16
    512^2 with seeded weights and BN state: the flagship f32 and bf16
    (buckets 1-16, depth 2, the uint8 wire; `serve_config` with chaos,
    reload, throughput, latency and idle share), then the edge and quality
    tiers through `apply_tier`, bf16."""
    import numpy as np
    import torch
    from real_time_helmet_detection_tpu_torch.config import (Config,
                                                             apply_tier)
    images = np.random.default_rng(0).integers(
        0, 256, (16, 512, 512, 3), dtype=np.uint8)
    out = state.setdefault("serve", {})
    runs = [("flagship f32", Config(batch_size=16, imsize=512), True),
            ("flagship bf16", Config(batch_size=16, imsize=512, amp=True),
             True),
            ("edge bf16", apply_tier(Config(tier="edge", batch_size=16,
                                            imsize=512, amp=True)), False),
            ("quality bf16", apply_tier(Config(tier="quality",
                                               batch_size=16, imsize=512,
                                               amp=True)), False)]
    for label, cfg, full in runs:
        t0 = time.perf_counter()
        rec = serve_config("serve " + label, cfg, images, seed=3, full=full)
        rec["secs"] = time.perf_counter() - t0
        out[label] = rec
        log("serve %s: engine built in %.2f s; per bucket capture s / graph "
            "nodes: %s; graphs hold %.3f GB; peak memory %.2f GB"
            % (label, rec["build_s"], ", ".join(
                "b%d %.3f / %s" % (b, r["capture_s"], r["nodes"])
                for b, r in rec["buckets"].items()), rec["graph_gb"],
               rec["peak_gb"]))
        log("serve %s: launches per replay (profiler, every bucket) %s; "
            "rows bit-equal to eager at each batch size; across buckets %d "
            "of %d rows differ from the largest bucket's in some bit, "
            "logits by up to %g%s, %d of %d detections >= 0.1 matched both "
            "ways; %.1f s (%.1f s in the profiler)" % (
                label, {k: v for k, v in rec["launches"].items() if v},
                rec["rows_differ"], rec["rows_compared"], rec["logit_err"],
                "" if rec["bf16_vs_f32"] is None else
                " (bf16 vs f32 at the largest bucket: %g)"
                % rec["bf16_vs_f32"], rec["matched"], rec["checked"],
                rec["secs"], rec["trace_s"]))
        eng = rec["rates"]["engine"]
        line = ("serve %s: saturated closed loop (64 outstanding) median "
                "%.1f img/s (min %.1f, max %.1f over %d windows)" % (
                    label, float(np.median(eng)), min(eng), max(eng),
                    len(eng)))
        if "eager" in rec["rates"]:
            ea = rec["rates"]["eager"]
            line += "; eager predict b16 median %.1f img/s (min %.1f, max " \
                    "%.1f)" % (float(np.median(ea)), min(ea), max(ea))
            tag = label.split()[-1]
            if tag in state.get("main", {}):
                line += ", phase main's %.1f" % state["main"][tag]["rates"][
                    "kernels"]["median_ips"]
        log(line + "; serial bucket 1 latency p50 %.3f ms, p99 %.3f ms"
            % (rec["p50_ms"], rec["p99_ms"]))
        if full:
            log("serve %s: chaos %s retried bit-identically (%d retries, %d "
                "hung); reload kept every storage, %d of 16 rows changed, "
                "all equal to eager with the new weights; idle share %s "
                "(device busy %.2f ms of a traced %.2f ms window)" % (
                    label, rec["chaos"]["fired"], rec["chaos"]["retried"],
                    rec["chaos"]["hung"], rec["reload"]["changed"],
                    "not measured (no device time)" if rec["idle"] is None
                    else "%.1f%%" % (100 * rec["idle"]), rec["busy_ms"],
                    rec["traced_ms"]))


# ----------------------------------------------------- int8 (#14 - #16)

# the configurations of the int8 phases, at b16 512^2: the JAX package's
# throughput tier (ghost blocks at width 96, stem width 96, int8
# inference, buckets 4/8/16; ref config.py:77-80) and the flagship with
# --infer-dtype int8
INT8_CONFIGS = ("throughput", "flagship-int8")
# dense int8 tensor-core peak of the H100 SXM (data sheet); the depthwise
# conv and the quantizer run on the CUDA cores: 64 INT32 lanes an SM, half
# the 128 FP32 lanes behind the data sheet's 67 TFLOP/s
INT8_OPS_PER_S = 1979e12
INT32_OPS_PER_S = 33.5e12
# the deadline of the served throughput tier's open loops and of the SLO
# watchdog's latency-burn rule: a tenth of a second
SERVE_DEADLINE_MS = 100.0


def int8_cfg(name, amp):
    """The port's Config of one of INT8_CONFIGS (bf16 under --amp)."""
    from real_time_helmet_detection_tpu_torch.config import (Config,
                                                             apply_tier)
    if name == "throughput":
        return apply_tier(Config(tier="throughput", batch_size=16,
                                 imsize=512, amp=amp))
    return Config(batch_size=16, imsize=512, amp=amp, infer_dtype="int8")


def int8_predict(cfg, seed, scales=None):
    """(float model, activation scales, int8 predict) of cfg's
    architecture with seeded weights and BN state (`perturb_bn`): the
    scales calibrated on the card over two seeded b16 batches of raw
    pixels unless given."""
    from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state
    from real_time_helmet_detection_tpu_torch.ops import quant
    from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
    model = perturb_bn(load_eval_state(cfg), seed=seed)
    if scales is None:
        scales = quant.calibrate_scales(
            cfg, model.state_dict(), quant.synthetic_calibration_batches(
                16, cfg.imsize, n=2, raw=True, seed=seed),
            dtype=model.dtype, normalize="imagenet")
    return model, scales, make_predict_fn(model, cfg, normalize="imagenet",
                                          quant_scales=scales)


def int8_sites(cfg):
    """{(kind, input shape, out channels, k): calls} of one b16 forward of
    cfg's int8 twin on the card, kind dense | dw, recorded from its
    QuantConvs (random weights; the shapes are what matter)."""
    import torch
    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        QuantConv
    from real_time_helmet_detection_tpu_torch.ops import quant
    dtype = torch.bfloat16 if cfg.amp else None
    twin = quant.make_quant_model(cfg, dtype=dtype, mode="int8")
    twin = twin.cuda().eval()
    sites = {}

    def hook(mod, args, _out):
        key = ("dw" if mod.depthwise else "dense", tuple(args[0].shape),
               mod.weight.shape[0], mod.k)
        sites[key] = sites.get(key, 0) + 1
    handles = [m.register_forward_hook(hook) for m in twin.modules()
               if isinstance(m, QuantConv)]
    x = torch.zeros((16, cfg.imsize, cfg.imsize, 3), device="cuda")
    with torch.inference_mode():
        twin(x)
    for h in handles:
        h.remove()
    del twin
    return sites


def quant_sites(cfg):
    """{(input shape, at two steps): calls} of the quantizer in one b16
    forward of cfg's int8 twin on the card (random weights): where no
    int8 conv writes a conv's input codes."""
    import torch
    from real_time_helmet_detection_tpu_torch.ops import qconv, quant
    dtype = torch.bfloat16 if cfg.amp else None
    twin = quant.make_quant_model(cfg, dtype=dtype, mode="int8")
    twin = twin.cuda().eval()
    sites = {}
    real = qconv.quantize_act

    def record(x, step, step2=None):
        key = (tuple(x.shape), step2 is not None)
        sites[key] = sites.get(key, 0) + 1
        return real(x, step, step2)
    x = torch.zeros((16, cfg.imsize, cfg.imsize, 3), device="cuda")
    with swapped([(qconv, "quantize_act", record)]), torch.inference_mode():
        twin(x)
    del twin
    return sites


def qconv_operands(kind, shape, cout, k, gen, offset=0):
    """Seeded int8 input and weights and float32 (mult, bias) of one int8
    conv site; the input a channels-last view `offset` bytes into its
    storage where asked."""
    import torch
    n, c, h, w = shape
    base = torch.randint(-127, 128, (n * h * w * c + offset,), generator=gen,
                         device="cuda", dtype=torch.int8)
    q = base[offset:].view(n, h, w, c).permute(0, 3, 1, 2)
    wshape = (9, c) if kind == "dw" else (cout, k, k, c)
    wq = torch.randint(-127, 128, wshape, generator=gen, device="cuda",
                       dtype=torch.int8)
    mult = torch.rand((cout,), generator=gen, device="cuda") * 1e-3 + 1e-5
    bias = torch.randn((cout,), generator=gen, device="cuda")
    return q, wq, mult, bias


def qconv_variants(kind, c):
    """The kernels an int8 conv of `c` input channels can take: the dense
    conv's wgmma and mma kernels; the depthwise conv's tiled kernel (C %
    16 == 0) and its gather kernel."""
    if kind == "dense":
        return ("wgmma", "mma")
    return ("tiled", "gather") if c % 16 == 0 else ("gather",)


def qconv_case(kind, shape, cout, k, gen, errs, label, offset=0):
    """One int8 conv site against its plain version on each of its
    kernels (`qconv_variants`): the int32 sums bit-equal, then the
    float32 and bfloat16 outputs with ReLU and Linear bit-equal (the
    plain rescale of the plain sums). Returns the number of
    comparisons."""
    import torch
    from real_time_helmet_detection_tpu_torch.ops import qconv
    q, wq, mult, bias = qconv_operands(kind, shape, cout, k, gen, offset)
    conv = qconv.conv_dw_variant if kind == "dw" else qconv.conv_dense_variant
    ref = (qconv.conv_dw_reference if kind == "dw"
           else qconv.conv_dense_reference)
    acc = ref(q, wq, mult, bias, torch.int32, "Linear")
    n = 0
    for var in qconv_variants(kind, shape[1]):
        errs[(kind, "i32", var, label)] = compare(
            "%s %s int32 %s" % (kind, var, label),
            conv(q, wq, mult, bias, torch.int32, "Linear", var), acc,
            "equal")
        n += 1
        for dtype in (torch.float32, torch.bfloat16):
            tag = "f32" if dtype == torch.float32 else "bf16"
            for act in ("ReLU", "Linear"):
                want = qconv.rescale_reference(acc, mult, bias, dtype, act)
                errs[(kind, tag, act, var, label)] = compare(
                    "%s %s %s %s %s" % (kind, var, tag, act, label),
                    conv(q, wq, mult, bias, dtype, act, var), want, "equal")
                n += 1
    return n


def quant_case(x, step, errs, label, step2=None):
    """The quantizer at one step (and, given `step2`, at two in one
    launch) against its plain version, bit-equal."""
    from real_time_helmet_detection_tpu_torch.ops import qconv
    errs[("quantize_act", label)] = compare(
        "quantize_act %s" % (label,), qconv.quantize_act(x, step),
        qconv.quantize_act_reference(x, step), "equal")
    if step2 is None:
        return 1
    got = qconv.quantize_act(x, step, step2)
    want = qconv.quantize_act_reference(x, step, step2)
    for i in range(2):
        errs[("quantize_act", "dual", i, label)] = compare(
            "quantize_act at two steps (%d) %s" % (i, label), got[i],
            want[i], "equal")
    return 3


def absmax_case(x, errs, label):
    """The abs-max kernel against `x.abs().amax()` (NaN-aware)."""
    from real_time_helmet_detection_tpu_torch.ops import qconv
    errs[("abs_max", label)] = compare(
        "abs_max %s" % (label,), qconv.abs_max(x),
        qconv.abs_max_reference(x), "nan_equal")
    return 1


# the code outputs a fused site is checked with: (dtype, activation,
# store the float output, code outputs), the first code output at
# channel offset Cout of a 2 * Cout + 16 wide tensor (a concat's second
# half), the second (where asked) alone
QCODE_FORMS = (("bf16", "ReLU", False, 2), ("bf16", "Linear", True, 1),
               ("f32", "ReLU", True, 2))


def qcodes_case(kind, shape, cout, k, gen, errs, label, offset=0):
    """One int8 conv site's code outputs against the plain version, on
    each of its kernels, in each of QCODE_FORMS: the float output (where
    stored), each code output, and the wide tensor's channels outside
    the conv's left as they were, bit-equal. Returns the number of
    comparisons."""
    import torch
    from real_time_helmet_detection_tpu_torch.ops import qconv
    q, wq, mult, bias = qconv_operands(kind, shape, cout, k, gen, offset)
    conv = qconv.conv_dw_variant if kind == "dw" else qconv.conv_dense_variant
    ref = (qconv.conv_dw_reference if kind == "dw"
           else qconv.conv_dense_reference)
    n, _, h, w = shape
    step = torch.rand((), generator=gen, device="cuda") * 0.05 + 0.01
    step2 = torch.rand((), generator=gen, device="cuda") * 0.05 + 0.01
    count = 0
    for tag, act, store, ncodes in QCODE_FORMS:
        dtype = torch.bfloat16 if tag == "bf16" else torch.float32
        want = ref(q, wq, mult, bias, dtype, act)
        wide = channels_last(torch.full((n, 2 * cout + 16, h, w), 77,
                                        dtype=torch.int8, device="cuda"))
        alone = channels_last(torch.zeros((n, cout, h, w), dtype=torch.int8,
                                          device="cuda"))
        codes = [(wide, step, cout), (alone, step2, 0)][:ncodes]
        for var in qconv_variants(kind, shape[1]):
            wide.fill_(77)
            alone.fill_(0)
            got = conv(q, wq, mult, bias, dtype, act, var, store, codes)
            key = (kind, "codes", tag, act, store, ncodes, var, label)
            if store:
                errs[key + ("out",)] = compare("%s out" % (key,), got, want,
                                               "equal")
            else:
                require(got is None, "%s: a float output without store"
                        % (key,))
            errs[key] = compare("%s codes" % (key,),
                                wide[:, cout:2 * cout],
                                qconv.quantize_act_reference(want, step),
                                "equal")
            require(bool((wide[:, :cout] == 77).all()
                         and (wide[:, 2 * cout:] == 77).all()),
                    "%s: channels outside the conv's were written" % (key,))
            if ncodes == 2:
                errs[key + (2,)] = compare(
                    "%s codes 2" % (key,), alone,
                    qconv.quantize_act_reference(want, step2), "equal")
            count += 1 + store + (ncodes == 2)
    return count


# off the main path: (N, Cin, H, W, Cout, k) for the dense conv: a Cin of
# 16 and 48 (a half-filled K step or chunk), 144 (chunks of 64: 64 + 64 +
# 16), 256, a Cout of 8 and 24 (wgmma width 32), 72, 136 and 200 (widths
# 96 and 256, rows past Cout), 264 (two channel blocks), a W and H that
# are no multiple of the box, one image at 8^2 and 1^2, a 1x1 image;
# (N, C, H, W) for the depthwise conv: C % 16 != 0 (the gather kernel
# only), 144 and 80 (channel tiles of 64 and a ragged one), one image at
# 8^2 and 1^2, W and H no multiple of the tile; odd element counts for
# the quantizer
QDENSE_ODD = [(1, 16, 5, 7, 8, 1), (3, 48, 9, 13, 24, 3),
              (2, 144, 11, 6, 72, 3), (1, 256, 3, 3, 136, 1),
              (2, 32, 1, 1, 8, 3), (5, 16, 17, 19, 200, 3),
              (1, 128, 8, 8, 128, 3), (1, 64, 1, 1, 96, 3),
              (2, 32, 20, 37, 264, 1), (1, 48, 23, 29, 264, 3)]
QDW_ODD = [(1, 8, 5, 7), (3, 24, 9, 13), (2, 136, 11, 6), (1, 8, 1, 1),
           (1, 48, 8, 8), (1, 16, 1, 1), (2, 144, 19, 37), (3, 80, 17, 33)]
# a channels-last view 16 bytes into its storage: (kind, shape, Cout, k)
QOFFSET = [("dense", (2, 64, 13, 21), 96, 3), ("dw", (2, 48, 13, 21), 48, 3)]
QUANT_ODD = [(3, 5, 7, 9), (1, 3, 1, 1), (2, 16, 9, 13)]
# the code outputs off the main path: a ragged box and one image of the
# dense conv (Cout 8 and 24: one and three n8 blocks; 264: two channel
# blocks), the gather depthwise kernel (C % 16 != 0) and a ragged tile
QCODES_ODD = [(3, 48, 9, 13, 24, 3), (1, 16, 5, 7, 8, 1),
              (2, 32, 20, 37, 264, 1)]
QDW_CODES_ODD = [(3, 24, 9, 13), (3, 80, 17, 33)]
# what JAX-CPU's int8 quantizer gives for NaN input (tests/
# test_torch_quant.py holds the port's plain version to it)
JAX_NAN_TO_INT8 = 0


def phase_qkernels(state):
    """The int8 kernels (#14 - #16) against their plain versions on the
    card: at every int8 site of a b16 512^2 forward of the throughput tier
    and the flagship (bf16), the int32 sums and the f32 and bf16
    ReLU/Linear outputs bit-equal, the quantizer bit-equal in f32 and
    bf16; then off the main path (QDENSE_ODD, QDW_ODD, QUANT_ODD); the
    quantizer's ties at .5, +-inf (clipped to +-127), saturation and NaN
    (0, JAX-CPU's value); and the wrappers' refusals (a misaligned
    pointer, a layout that is not channels-last, a Cin the dense kernel
    does not take)."""
    import torch
    from real_time_helmet_detection_tpu_torch.ops import qconv
    gen = torch.Generator(device="cuda").manual_seed(5)
    errs = state.setdefault("qerrs", {})
    n = 0
    all_sites = {}
    for name in INT8_CONFIGS:
        sites = int8_sites(int8_cfg(name, amp=True))
        state.setdefault("int8_sites", {})[name] = sites
        state.setdefault("quant_sites", {})[name] = quant_sites(
            int8_cfg(name, amp=True))
        all_sites.update(sites)
    quant_shapes = set()
    for (kind, shape, cout, k), _calls in sorted(all_sites.items()):
        n += qconv_case(kind, shape, cout, k, gen, errs, (shape, cout, k))
        quant_shapes.add(shape)
    # the code outputs at every int8 conv site of the throughput tier
    fused = state["int8_sites"]["throughput"]
    for kind, shape, cout, k in sorted(fused):
        n += qcodes_case(kind, shape, cout, k, gen, errs, (shape, cout, k))
    for shape in sorted(quant_shapes):
        step = torch.rand((), generator=gen, device="cuda") * 0.05 + 0.01
        step2 = torch.rand((), generator=gen, device="cuda") * 0.05 + 0.01
        for dtype in (torch.float32, torch.bfloat16):
            x = channels_last(rand(shape, dtype, gen, 2.0))
            n += quant_case(x, step, errs, (shape, str(dtype)), step2)
            n += absmax_case(x, errs, (shape, str(dtype)))
    for nb, cin, h, w, cout, k in QDENSE_ODD:
        n += qconv_case("dense", (nb, cin, h, w), cout, k, gen, errs,
                        ("odd", nb, cin, h, w, cout, k))
    for shape in QDW_ODD:
        n += qconv_case("dw", shape, shape[1], 3, gen, errs, ("odd",) + shape)
    for kind, shape, cout, k in QOFFSET:
        n += qconv_case(kind, shape, cout, k, gen, errs,
                        ("offset 16",) + shape, offset=16)
        n += qcodes_case(kind, shape, cout, k, gen, errs,
                         ("offset 16",) + shape, offset=16)
    for nb, cin, h, w, cout, k in QCODES_ODD:
        n += qcodes_case("dense", (nb, cin, h, w), cout, k, gen, errs,
                         ("odd", nb, cin, h, w, cout, k))
    for shape in QDW_CODES_ODD:
        n += qcodes_case("dw", shape, shape[1], 3, gen, errs,
                         ("odd",) + shape)
    for shape in QUANT_ODD:
        for dtype in (torch.float32, torch.bfloat16):
            x = channels_last(rand(shape, dtype, gen, 3.0))
            n += quant_case(x, torch.tensor(0.0173, device="cuda"), errs,
                            ("odd", shape, str(dtype)),
                            torch.tensor(0.031, device="cuda"))
            n += absmax_case(x, errs, ("odd", shape, str(dtype)))
    # ties at .5 (a power-of-two step: x / step exact), +-inf, saturation,
    # NaN
    step = torch.tensor(0.25, device="cuda")
    ties = (torch.arange(-130, 130, device="cuda", dtype=torch.float32)
            + 0.5) * 0.25
    special = torch.tensor([float("inf"), float("-inf"), float("nan"), 1e30,
                            -1e30, 31.75, -31.75, 0.125, -0.125],
                           device="cuda")
    flat = torch.cat([ties, special])
    x = flat.view(1, 1, 1, -1).permute(0, 3, 1, 2)
    x = channels_last(x)
    for dtype in (torch.float32, torch.bfloat16):
        xd = channels_last(x.to(dtype))
        n += quant_case(xd, step, errs, ("special", str(dtype)),
                        torch.tensor(0.5, device="cuda"))
        n += absmax_case(xd, errs, ("special", str(dtype)))
        # the abs-max without the NaN: +inf; of -0.0 alone: +0.0
        nt = len(ties)
        finite = channels_last(xd[:, :nt])
        n += absmax_case(finite, errs, ("ties", str(dtype)))
        inf = xd[:, nt:nt + 2].clone()
        n += absmax_case(channels_last(inf), errs, ("inf", str(dtype)))
        zero = torch.full((2, 8, 3, 5), -0.0, dtype=dtype, device="cuda")
        n += absmax_case(zero, errs, ("-0.0", str(dtype)))
        require(not bool(torch.signbit(qconv.abs_max(zero))),
                "abs_max of -0.0: -0.0, want +0.0")
    got = qconv.quantize_act(x, step).reshape(-1).cpu().tolist()
    t = ties.cpu().tolist()
    want_ties = [max(-127, min(127, round(v / 0.25))) for v in t]
    require(got[:len(t)] == want_ties, "quantize_act: ties at .5 do not "
            "round half to even or do not saturate at +-127")
    inf, ninf, nan, big, nbig, hi, lo, half, nhalf = got[len(t):]
    require((inf, ninf, nan, big, nbig, hi, lo, half, nhalf)
            == (127, -127, JAX_NAN_TO_INT8, 127, -127, 127, -127, 0, 0),
            "quantize_act special values: +inf %d, -inf %d, NaN %d, "
            "+-1e30 %d %d, +-127 %d %d, +-0.5 %d %d" % (
                inf, ninf, nan, big, nbig, hi, lo, half, nhalf))
    # the refusals: no fallback to the plain version on the card
    q, wq, mult, bias = qconv_operands("dense", (2, 32, 8, 8), 16, 3, gen)
    base = torch.randint(-127, 128, (2 * 32 * 8 * 8 + 1,), generator=gen,
                         device="cuda", dtype=torch.int8)
    misaligned_q = base[1:].view(2, 8, 8, 32).permute(0, 3, 1, 2)
    codes_base = torch.zeros((2 * 16 * 8 * 8 + 8,), device="cuda",
                             dtype=torch.int8)
    misaligned_codes = codes_base[8:].view(2, 8, 8, 16).permute(0, 3, 1, 2)
    refused = {}
    for label, fn in (
            ("misaligned", lambda: qconv.conv_dense(
                misaligned_q, wq, mult, bias, torch.float32)),
            ("not channels-last", lambda: qconv.conv_dense(
                q.contiguous(), wq, mult, bias, torch.float32)),
            ("Cin 24", lambda: qconv.conv_dense(
                q[:, :24].contiguous(memory_format=torch.channels_last),
                wq[..., :24].contiguous(), mult, bias, torch.float32)),
            ("5x5", lambda: qconv.conv_dense(
                q, torch.zeros((16, 5, 5, 32), dtype=torch.int8,
                               device="cuda"), mult, bias, torch.float32)),
            ("quantize misaligned", lambda: qconv.quantize_act(
                rand((17,), torch.float32, gen)[1:].view(1, 1, 1, 16),
                step)),
            ("codes misaligned", lambda: qconv.conv_dense(
                q, wq, mult, bias, torch.bfloat16, "Linear", True,
                [(misaligned_codes, step, 0)])),
            ("codes offset 4", lambda: qconv.conv_dense(
                q, wq, mult, bias, torch.bfloat16, "Linear", True,
                [(channels_last(torch.zeros((2, 24, 8, 8), device="cuda",
                                            dtype=torch.int8)), step, 4)])),
            ("codes of int32 sums", lambda: qconv.conv_dense(
                q, wq, mult, bias, torch.int32, "Linear", True,
                [(channels_last(torch.zeros((2, 16, 8, 8), device="cuda",
                                            dtype=torch.int8)), step, 0)])),
            ("abs_max misaligned", lambda: qconv.abs_max(
                rand((17,), torch.bfloat16, gen)[1:]))):
        try:
            fn()
            refused[label] = False
        except ValueError:
            refused[label] = True
    require(all(refused.values()), "wrappers did not refuse: %s"
            % [k for k, v in refused.items() if not v])
    state["qkernels"] = dict(n=n, sites=len(all_sites))
    log("qkernels: %d comparisons bit-equal against the plain versions: "
        "the int32 sums and the f32/bf16 ReLU/Linear outputs, on each "
        "kernel of each conv (dense: wgmma, mma; depthwise: tiled, "
        "gather), at all %d int8 conv sites of the throughput tier and the "
        "flagship at b16 512^2, at %d odd shapes and on views 16 bytes "
        "into their storage; the code outputs (%s: float output, codes at "
        "a channel offset of a wider tensor whose other channels stay, a "
        "second code output) on each kernel at all %d throughput-tier "
        "sites and %d odd shapes; the quantizer at one and two steps and "
        "the abs-max at every site input, odd counts, ties at .5 (half to "
        "even), +-inf and +-1e30 (+-127) and NaN (%d, JAX-CPU's value; the "
        "abs-max NaN), -0.0 (abs-max +0.0); refused: %s"
        % (n, len(all_sites), len(QDENSE_ODD) + len(QDW_ODD),
           ", ".join("%s %s store %s codes %d" % f for f in QCODE_FORMS),
           len(fused), len(QCODES_ODD) + len(QDW_CODES_ODD),
           JAX_NAN_TO_INT8, ", ".join(refused)))


def im2col_int8(q, k):
    """(N*H*W, k*k*C) int8 rows of a channels-last int8 input, taps in
    (ky, kx) order, zero padding k // 2: the library yardstick's input."""
    import torch
    import torch.nn.functional as F
    n, c, h, w = q.shape
    p = k // 2
    x = F.pad(q.permute(0, 2, 3, 1), (0, 0, p, p, p, p))
    taps = [x[:, dy:dy + h, dx:dx + w, :] for dy in range(k)
            for dx in range(k)]
    return torch.cat(taps, dim=3).reshape(n * h * w, k * k * c)


def qconv_timing(kind, shape, cout, k, gen):
    """Graph-replay ms of one int8 conv site, bf16 out, Linear: the
    kernel the plan takes and the other one (the first design), in turns
    (new, old, old, new; each the mean of its two), the plain version,
    for a dense conv the library's int32 sums alone (`torch._int_mm` on
    the input rows, an im2col for 3x3, built outside the timing), and as
    a float yardstick cuDNN's bf16 conv at the same shape; the bound and
    what bounds it; the host time of issuing each kernel from Python.
    For a depthwise conv the library is cuDNN's float32 conv of the int8
    values (groups = C). Fails unless the library's sums equal the
    kernel's."""
    import torch
    import torch.nn.functional as F
    from real_time_helmet_detection_tpu_torch.ops import qconv
    q, wq, mult, bias = qconv_operands(kind, shape, cout, k, gen)
    n, c, h, w = shape
    m = n * h * w
    new, old = qconv_variants(kind, c)
    if kind == "dw":
        conv = qconv.conv_dw_variant
        ref = lambda: qconv.conv_dw_reference(  # noqa: E731
            q, wq, mult, bias, torch.bfloat16, "Linear")
        ops, peak = 2.0 * m * c * 9, INT32_OPS_PER_S
        wf = wq.t().reshape(c, 1, 3, 3)
        groups = c
        # float32 holds these sums exactly (|sum| <= 9 * 127^2 < 2^24; a
        # TF32 operand holds an int8 value)
        x32 = channels_last(q.to(torch.float32))
        w32 = wf.to(torch.float32).contiguous(
            memory_format=torch.channels_last)
        lib = lambda: F.conv2d(x32, w32, padding=1,  # noqa: E731
                               groups=c)
        lib_ms = graph_ms(lib)
        acc = qconv.conv_dw(q, wq, mult, bias, torch.int32)
        lib_equal = bool(torch.equal(lib().round().to(torch.int32), acc))
        del x32, w32, acc
    else:
        conv = qconv.conv_dense_variant
        ref = lambda: qconv.conv_dense_reference(  # noqa: E731
            q, wq, mult, bias, torch.bfloat16, "Linear")
        ops, peak = 2.0 * m * c * k * k * cout, INT8_OPS_PER_S
        rows = (q.permute(0, 2, 3, 1).reshape(m, c) if k == 1
                else im2col_int8(q, k))
        w2d = wq.reshape(cout, -1)
        lib_ms = graph_ms(lambda: torch._int_mm(rows, w2d.t()))
        acc = qconv.conv_dense(q, wq, mult, bias, torch.int32)
        lib_equal = bool(torch.equal(
            torch._int_mm(rows, w2d.t()),
            acc.permute(0, 2, 3, 1).reshape(m, cout)))
        del rows, acc
        wf = wq.permute(0, 3, 1, 2)
        groups = 1
    require(lib_equal, "%s %s: the library's sums differ from the kernel's"
            % (kind, shape))
    xf = channels_last(q.to(torch.bfloat16))
    wf = wf.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    cudnn_ms = graph_ms(lambda: F.conv2d(xf, wf, padding=k // 2,
                                         groups=groups))
    del xf, wf
    turns = {new: [], old: []}
    for var in (new, old, old, new):
        turns[var].append(graph_ms(lambda: conv(  # noqa: B023
            q, wq, mult, bias, torch.bfloat16, "Linear", var)))
    nbytes = q.numel() + wq.numel() + m * cout * 2
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / peak * 1e3
    fn = lambda: conv(q, wq, mult, bias, torch.bfloat16,  # noqa: E731
                      "Linear", new)
    host = {new: [], old: []}
    for var in (new, old, old, new):
        host[var].append(host_us(lambda: conv(  # noqa: B023
            q, wq, mult, bias, torch.bfloat16, "Linear", var)))
    host = {var: sum(v) / 2 for var, v in host.items()}
    return dict(ms=sum(turns[new]) / 2, old_ms=sum(turns[old]) / 2,
                turns=turns, variant=new, old_variant=old, host_us=host,
                eager_ms=eager_ms(fn),
                plain_ms=graph_ms(ref, calls=2, replays=2),
                library_ms=lib_ms, library_equal=lib_equal,
                cudnn_bf16_ms=cudnn_ms,
                bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes_ms=by_bytes, ops_ms=by_ops, shape=shape, cout=cout,
                k=k)


def codes_timing(kind, shape, cout, k, gen, ncodes, activation):
    """Graph-replay ms of one int8 conv site in its fused form (no float
    output, `ncodes` code outputs) in turns with the unfused form it
    replaces (the conv's bf16 output, then one quantizer launch a code
    output: fused, unfused, unfused, fused), beside the fused form's
    bound (input, weights and codes once; its operations) and plain
    version."""
    import torch
    from real_time_helmet_detection_tpu_torch.ops import qconv
    q, wq, mult, bias = qconv_operands(kind, shape, cout, k, gen)
    n, c, h, w = shape
    m = n * h * w
    conv = qconv.conv_dw if kind == "dw" else qconv.conv_dense
    ref = (qconv.conv_dw_reference if kind == "dw"
           else qconv.conv_dense_reference)
    codes = [(channels_last(torch.empty((n, cout, h, w), device="cuda",
                                        dtype=torch.int8)),
              torch.tensor(0.02 * (i + 1), device="cuda"), 0)
             for i in range(ncodes)]

    def fused():
        conv(q, wq, mult, bias, torch.bfloat16, activation, False, codes)

    def unfused():
        y = conv(q, wq, mult, bias, torch.bfloat16, activation)
        for _, step, _ in codes:
            qconv.quantize_act(y, step)
    turns = {"fused": [], "unfused": []}
    for key in ("fused", "unfused", "unfused", "fused"):
        turns[key].append(graph_ms(fused if key == "fused" else unfused))
    if kind == "dw":
        ops, peak = 2.0 * m * c * 9, INT32_OPS_PER_S
    else:
        ops, peak = 2.0 * m * c * k * k * cout, INT8_OPS_PER_S
    by_bytes = (q.numel() + wq.numel() + ncodes * m * cout) \
        / HBM_BYTES_PER_S * 1e3
    by_ops = ops / peak * 1e3
    return dict(ms=sum(turns["fused"]) / 2,
                unfused_ms=sum(turns["unfused"]) / 2, turns=turns,
                plain_ms=graph_ms(lambda: ref(q, wq, mult, bias,
                                              torch.bfloat16, activation,
                                              False, codes),
                                  calls=2, replays=2),
                bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                shape=shape, cout=cout, k=k, codes=ncodes)


def site_bytes_of(site):
    kind, (n, c, h, w), cout, k = site
    return n * h * w * (c + 2 * cout)


def phase_qtiming(state):
    """The int8 kernels' device time by CUDA graph replay (CUDA events),
    bf16, at the throughput tier's largest sites (by bytes) of each
    kind, the flagship's largest dense 3x3 site and its 3x3 site at 128^2
    (8 a predict), and the quantizer at the throughput tier's largest
    conv input, beside the bound (the larger of bytes / 3.35 TB/s and
    operations / the peak of their type), the plain version, each conv's
    first-design kernel in turns with the one its plan takes, the
    library's int32 sums alone (no rescale: `torch._int_mm` on the same
    int8 rows for the dense conv, cuDNN's float32 grouped conv of the
    int8 values for the depthwise one), and cuDNN's bf16 conv (a float
    yardstick)."""
    import torch
    from real_time_helmet_detection_tpu_torch.ops import qconv
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = state.setdefault("qtiming", {})
    tp = state["int8_sites"]["throughput"]
    fl = state["int8_sites"]["flagship-int8"]
    dense = max((s for s in tp if s[0] == "dense"), key=site_bytes_of)
    dw = max((s for s in tp if s[0] == "dw"), key=site_bytes_of)
    dense3 = max((s for s in fl if s[0] == "dense" and s[3] == 3),
                 key=lambda s: s[1][0] * s[1][2] * s[1][3] * s[1][1] * s[2])
    dense3_128 = ("dense", (16, dense3[1][1], 128, 128), dense3[2], 3)
    require(dense3_128 in fl, "the flagship has no 3x3 site at 128^2")
    rows["qconv_dense"] = qconv_timing(*dense, gen)
    rows["qconv_dense_3x3"] = qconv_timing(*dense3, gen)
    rows["qconv_dense_3x3_128"] = qconv_timing(*dense3_128, gen)
    rows["qconv_dw"] = qconv_timing(*dw, gen)
    shape = max((s[1] for s in tp), key=lambda s: math.prod(s))
    x = channels_last(rand(shape, torch.bfloat16, gen, 2.0))
    step = torch.tensor(0.02, device="cuda")
    nbytes = x.numel() * 3
    # the library: torch.quantize_per_tensor, int8(clip(rint(x * (1 /
    # s)))) into [-128, 127], of the float32 values (it takes no bf16),
    # converted outside the timing; counted: the values where it differs
    # from the kernel (its product by 1/s against the kernel's quotient,
    # its -128)
    x32 = x.float()
    lib = lambda: torch.quantize_per_tensor(  # noqa: E731
        x32, 0.02, 0, torch.qint8)
    differ = int((lib().int_repr() != qconv.quantize_act(x, step)).sum())
    rows["quantize_act"] = dict(
        ms=graph_ms(lambda: qconv.quantize_act(x, step)),
        eager_ms=eager_ms(lambda: qconv.quantize_act(x, step)),
        plain_ms=graph_ms(lambda: qconv.quantize_act_reference(x, step)),
        library_ms=eager_ms(lib), library_equal=None, library_differ=differ,
        library_f32_ms=graph_ms(lambda: qconv.quantize_act(x32, step)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        shape=shape)
    del x, x32
    # the code outputs: the throughput tier's largest 1x1 site as a ghost
    # module's first 1x1 writes them (two, no float output), its largest
    # depthwise site (one), the flagship's largest 3x3 as a residual
    # block's Convolution_0 (one)
    fused = state.setdefault("qfused", {})
    fused["qconv_dense_codes"] = codes_timing(*dense, gen, 2, "ReLU")
    fused["qconv_dw_codes"] = codes_timing(*dw, gen, 1, "ReLU")
    fused["qconv_dense_3x3_codes"] = codes_timing(*dense3, gen, 1, "ReLU")
    # the quantizer at each site of the fused predicts, one and two steps
    qsites = state.setdefault("qsite_timing", {})
    for name in INT8_CONFIGS:
        for (shape, dual), calls in sorted(state["quant_sites"][name].items()):
            key = (shape, dual)
            if key in qsites:
                qsites[key]["calls"][name] = calls
                continue
            x = channels_last(rand(shape, torch.bfloat16, gen, 2.0))
            s2 = torch.tensor(0.03, device="cuda") if dual else None
            qsites[key] = dict(
                ms=graph_ms(lambda: qconv.quantize_act(  # noqa: B023
                    x, step, s2)),
                bound_ms=x.numel() * (3 + dual) / HBM_BYTES_PER_S * 1e3,
                calls={name: calls})
            del x
    # the abs-max at the flagship step's largest STE input
    x = channels_last(rand(BIG, torch.bfloat16, gen, 2.0))
    require(bool(torch.equal(qconv.abs_max(x),
                             torch.linalg.vector_norm(x, float("inf"))
                             .float())),
            "abs_max differs from torch.linalg.vector_norm(x, inf)")
    rows["abs_max"] = dict(
        ms=graph_ms(lambda: qconv.abs_max(x)),
        eager_ms=eager_ms(lambda: qconv.abs_max(x)),
        plain_ms=graph_ms(lambda: qconv.abs_max_reference(x)),
        library_ms=graph_ms(lambda: torch.linalg.vector_norm(
            x, float("inf"))),
        library_equal=True,
        bound_ms=x.numel() * 2 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        shape=BIG)
    del x
    torch.cuda.empty_cache()
    log("qtiming (ms per call, bf16, CUDA graph replay; eager = issued "
        "from Python; old = the first design's kernel, in turns new, old, "
        "old, new; host = microseconds of issuing one call from Python, "
        "in the same turns; library = the int32 sums alone, "
        "torch._int_mm's (dense) or cuDNN's float32 grouped conv's "
        "(depthwise); cuDNN bf16 = a float conv of the same shape, a "
        "yardstick only):")
    for key, r in rows.items():
        log("  %-20s kernel %.4f (eager %.4f)%s  plain %.4f  library %s%s"
            "%s  bound %.4f (%s, %.0f%% of it)  at %s%s" % (
                key, r["ms"], r["eager_ms"],
                "  %s %.4f vs %s %.4f (turns %s; host us %s %.1f, %s %.1f)"
                % (r["variant"], r["ms"], r["old_variant"], r["old_ms"],
                   r["turns"], r["variant"], r["host_us"][r["variant"]],
                   r["old_variant"], r["host_us"][r["old_variant"]])
                if "old_ms" in r else "",
                r["plain_ms"],
                "%.4f" % r["library_ms"] if r["library_ms"] is not None
                else "none",
                "" if r["library_equal"] is None else
                " (sums equal the kernel's: %s)" % r["library_equal"],
                "  cuDNN bf16 %.4f" % r["cudnn_bf16_ms"]
                if "cudnn_bf16_ms" in r else
                "  (library: torch.quantize_per_tensor of the f32 values, "
                "eager; %d of %d values differ from the kernel's; the "
                "kernel on those f32 values %.4f)" % (
                    r["library_differ"], math.prod(r["shape"]),
                    r["library_f32_ms"]) if "library_differ" in r else "",
                r["bound_ms"], r["bound_by"],
                100 * r["bound_ms"] / r["ms"], r["shape"],
                " -> %d, k %d" % (r["cout"], r["k"]) if "cout" in r
                else ""))
    log("  (abs_max: plain = x.abs().amax(), the ATen pair the STE ran "
        "before; library = torch.linalg.vector_norm(x, inf), equal)")
    for key, r in fused.items():
        log("  %-22s fused %.4f (codes %d, no float output) vs unfused "
            "%.4f (bf16 output + %d quantizer launches; turns %s)  plain "
            "%.4f  bound %.4f (%s, %.0f%% of it)  at %s -> %d, k %d" % (
                key, r["ms"], r["codes"], r["unfused_ms"], r["codes"],
                r["turns"], r["plain_ms"], r["bound_ms"], r["bound_by"],
                100 * r["bound_ms"] / r["ms"], r["shape"], r["cout"],
                r["k"]))
    for (shape, dual), r in sorted(qsites.items()):
        log("  quantize_act site %s%s: %.4f ms, bound %.4f (bytes, %.0f%% "
            "of it); calls a predict %s" % (
                shape, " at two steps" if dual else "", r["ms"],
                r["bound_ms"], 100 * r["bound_ms"] / r["ms"], r["calls"]))
    for name in INT8_CONFIGS:
        tot = sum(r["ms"] * r["calls"].get(name, 0) for r in qsites.values())
        bnd = sum(r["bound_ms"] * r["calls"].get(name, 0)
                  for r in qsites.values())
        log("  quantize_act over a %s predict's sites (replay sums): %.4f "
            "ms, bound %.4f (%.0f%%)" % (name, tot, bnd, 100 * bnd / tot))


def paired_rates(predicts, images, windows=3, window_s=1.0):
    """Images/s of each named predict in alternating windows of about
    `window_s` (at least 3 predicts each): {name: per-window rates}."""
    import torch

    def one_window(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(images)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    per = {k: max(3, int(window_s / (one_window(fn, 2) / 2)))
           for k, fn in predicts.items()}
    out = {k: [] for k in predicts}
    for _ in range(windows):
        for k, fn in predicts.items():
            out[k].append(len(images) * per[k] / one_window(fn, per[k]))
    return out


def loose_matches(a, b, min_score=0.1):
    """(detections >= min_score of `a` with one in `b` of the same class,
    IoU >= 0.5 and |score difference| <= 0.05, detections checked)."""
    import numpy as np
    a = [t.cpu().numpy() for t in a]
    b = [t.cpu().numpy() for t in b]
    hit = checked = 0
    for i in range(a[0].shape[0]):
        sel = b[3][i]
        bb, bc, bs = b[0][i][sel], b[1][i][sel], b[2][i][sel]
        for box, c, s, v in zip(a[0][i], a[1][i], a[2][i], a[3][i]):
            if not v or s < min_score:
                continue
            checked += 1
            hit += bool(((bc == c) & (np.abs(bs - s) <= 0.05)
                         & (box_iou(box, bb) >= 0.5)).any())
    return hit, checked


def int8_vs_float(dets_q, dets_f, twin, fmodel, images):
    """How far the int8 predict is from the float model of the same
    weights (a record): heat logits and their sigmoid scores, and the
    detections under phase main's rule and a loose one."""
    import torch
    lq, lf = served_logits(twin, images[:4]), served_logits(fmodel, images[:4])
    num_cls = lq.shape[-1] - 4
    hq, hf = lq[..., :num_cls].float(), lf[..., :num_cls].float()
    d = (hq - hf).abs()
    sd = (torch.sigmoid(hq) - torch.sigmoid(hf)).abs()
    n_a, miss_a = match_misses(dets_q, dets_f)
    n_b, miss_b = match_misses(dets_f, dets_q)
    return dict(heat_max=float(d.max()),
                heat_rel=float(d.max() / hf.abs().max()),
                score_max=float(sd.max()), score_mean=float(sd.mean()),
                strict=(n_a - len(miss_a), n_a, n_b - len(miss_b), n_b),
                loose=loose_matches(dets_q, dets_f)
                + loose_matches(dets_f, dets_q))


# kernel-name groups of the int8 and float predicts' device time
INT8_TRACE = ("quantize_kernel", "qconv_wgmma_kernel", "qconv_dense_kernel",
              "qconv_dw_tile_kernel", "qconv_dw_kernel", "peak_kernel")
FLOAT_TRACE = ("bn_act_vec_kernel", "bn_add_act_kernel", "peak_kernel")


def predict_profile(predict, images, ips, kernels):
    """Device ms of one b16 predict by group (a profiler trace of 3),
    against the untraced wall of `ips` images/s: busy, wall, idle share,
    groups."""
    by_name, _ = trace_device_ms(lambda i: predict(images), reps=3)
    busy = sum(by_name.values())
    wall = 1e3 * len(images) / ips
    return dict(busy=busy, wall=wall,
                idle=max(0.0, 1 - busy / wall) if busy else None,
                groups=group_device_ms(by_name, kernels))


def phase_int8(state):
    """The int8 predict (`--infer-dtype int8`) at b16 512^2 for
    INT8_CONFIGS, bf16 and f32: scales calibrated on the card, launch
    counts per predict against `expected_launches` (the quantizer and an
    int8 conv at each of `qconv_sites`, the peak test once, no BN kernel),
    logits bit-equal and Detections identical against the same twin with
    every kernel swapped for its plain version, finite logits of the
    expected shape, peak memory; in bf16 also images/s against the float
    model of the same architecture and weights in alternating windows and
    the int8-vs-float agreement of detections >= 0.1 (a record)."""
    import numpy as np
    import torch
    from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state
    from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
    images = np.random.default_rng(0).integers(
        0, 256, (16, 512, 512, 3), dtype=np.uint8)
    out = state.setdefault("int8", {})
    for name in INT8_CONFIGS:
        for amp in (True, False):
            tag = "bf16" if amp else "f32"
            label = "int8 %s %s" % (name, tag)
            cfg = int8_cfg(name, amp)
            dtype = torch.bfloat16 if amp else torch.float32
            t0 = time.perf_counter()
            model, scales, predict = int8_predict(cfg, seed=3)
            calib_s = time.perf_counter() - t0
            predict(images)
            torch.cuda.synchronize()
            reset_counts()
            dets = predict(images)  # THE run the counts read
            torch.cuda.synchronize()
            counts = read_counts()
            want = expected_launches(cfg, "predict", dtype)
            require(counts == want, "%s launches per predict %s, want %s"
                    % (label, {k: v for k, v in counts.items() if v},
                       {k: v for k, v in want.items() if v}))
            state.setdefault("launches", {})[label] = counts
            lk, lp = full_batch_logits(predict.model, images)
            side = cfg.imsize // 4
            require(bool(torch.isfinite(lk).all()) and tuple(lk.shape) == (
                16, cfg.num_stack, side, side, cfg.num_cls + 4),
                "%s logits malformed: %s" % (label, tuple(lk.shape)))
            with plain_kernels():
                dets_plain = predict(images)
            bit_equal = bool(torch.equal(lk, lp))
            identical = all(torch.equal(a, b)
                            for a, b in zip(dets, dets_plain))
            require(bit_equal and identical, "%s kernels vs plain: logits "
                    "bit-equal %s (max abs err %g), Detections identical "
                    "%s" % (label, bit_equal, float((lk - lp).abs().max()),
                            identical))
            del lk, lp
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            predict(images)
            torch.cuda.synchronize()
            rec = dict(counts=counts, calib_s=calib_s,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                       valid=int(dets.valid.sum()))
            if amp:
                fcfg = dataclasses.replace(cfg, infer_dtype="bf16")
                fmodel = perturb_bn(load_eval_state(fcfg), seed=3)
                fpredict = make_predict_fn(fmodel, fcfg, normalize="imagenet")
                rec["agree"] = int8_vs_float(dets, fpredict(images),
                                             predict.model, fmodel, images)
                rates = paired_rates({"int8": predict, "float": fpredict},
                                     images)
                rec["rates"] = rates
                rec["profile"] = {
                    path: predict_profile(fn, images, np.median(rates[path]),
                                          kernels)
                    for path, fn, kernels in (
                        ("int8", predict, INT8_TRACE),
                        ("float", fpredict, FLOAT_TRACE))}
                del fmodel, fpredict
            out[label] = rec
            log("%s: calibrated + built in %.1f s; launches per predict "
                "%s; logits bit-equal and Detections identical to the "
                "plain twin; %d valid after NMS; peak memory %.2f GB"
                % (label, calib_s, {k: v for k, v in counts.items() if v},
                   rec["valid"], rec["peak_gb"]))
            if amp:
                r = rec["rates"]
                a = rec["agree"]
                log("%s: images/s b16 512^2 int8 median %.1f (%s) vs the "
                    "float model %.1f (%s); int8 vs float (a record): "
                    "heat logits max |diff| %.4g (%.4g of the float's max "
                    "|logit|), scores max |diff| %.4g, mean %.4g; "
                    "detections >= 0.1 matched under phase main's rule %d "
                    "of %d / %d of %d, with the same class, IoU >= 0.5 and "
                    "|score diff| <= 0.05 %d of %d / %d of %d" % (
                        label, float(np.median(r["int8"])),
                        ", ".join("%.1f" % v for v in r["int8"]),
                        float(np.median(r["float"])),
                        ", ".join("%.1f" % v for v in r["float"]),
                        a["heat_max"], a["heat_rel"], a["score_max"],
                        a["score_mean"], *a["strict"], *a["loose"]))
                g = rec["profile"]["int8"]["groups"]
                rec["device_sums"] = dict(
                    dense=g["qconv_wgmma_kernel"] + g["qconv_dense_kernel"],
                    dw=g["qconv_dw_tile_kernel"] + g["qconv_dw_kernel"],
                    quant=g["quantize_kernel"],
                    float_conv=rec["profile"]["float"]["groups"][
                        "convolution"])
                log("%s: device ms per b16 predict: #14 (dense int8 convs) "
                    "%.3f, #15 (depthwise) %.3f, #16 (the quantizer, %d "
                    "launches) %.3f; the float model's convolutions %.3f; "
                    "int8 predict busy %.3f vs float %.3f"
                    % (label, rec["device_sums"]["dense"],
                       rec["device_sums"]["dw"], counts["quantize_act"],
                       rec["device_sums"]["quant"],
                       rec["device_sums"]["float_conv"],
                       rec["profile"]["int8"]["busy"],
                       rec["profile"]["float"]["busy"]))
                for path, pr in rec["profile"].items():
                    log("%s: %s predict device time (profiler, ms per b16 "
                        "predict) %.3f of an untraced %.3f ms: idle share "
                        "%s; by group %s" % (
                            label, path, pr["busy"], pr["wall"],
                            "not measured (no device time)"
                            if pr["idle"] is None
                            else "%.1f%%" % (100 * pr["idle"]),
                            ", ".join("%s %.3f" % kv
                                      for kv in pr["groups"].items())))
            del model, predict
            torch.cuda.empty_cache()


def phase_serve_int8(state):
    """`--tier throughput` through the serving engine (bf16, buckets
    4/8/16, 20 ms max wait, depth 2) with an SLO watchdog
    (`default_serving_rules`, the deadline SERVE_DEADLINE_MS): one graph
    per bucket and none after construction, each bucket's replay launches
    from a profiler trace against `expected_launches`, rows bit-equal to
    the eager int8 predict at each bucket's batch size; a closed loop of
    64 clients (`serving.loadgen`), then open loops of seeded Poisson
    arrivals at 50% and 90% of its rate with that deadline: p50/p99,
    on-time, shed, lost and the watchdog's alerts of each; a hot reload
    of other weights and rescaled activation scales (storages kept, no
    capture, rows equal to a fresh engine's on them); then the eval of a
    16-image fixture at `--tier throughput` (calibration on its first
    batch, through the engine) against eager int8 predicts with the
    scales it saved."""
    import numpy as np
    import torch
    from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state
    from real_time_helmet_detection_tpu_torch.obs.metrics import \
        MetricsRegistry
    from real_time_helmet_detection_tpu_torch.obs.slo import (
        SloWatchdog, default_serving_rules)
    from real_time_helmet_detection_tpu_torch.obs.spans import SpanTracer
    from real_time_helmet_detection_tpu_torch.serving import (
        ServingEngine, loadgen, resolve_buckets)
    images = np.random.default_rng(0).integers(
        0, 256, (16, 512, 512, 3), dtype=np.uint8)
    cfg = int8_cfg("throughput", amp=True)
    buckets = resolve_buckets(cfg)
    require(buckets == (4, 8, 16), "throughput tier buckets %s" % (buckets,))
    model, scales, predict = int8_predict(cfg, seed=3)
    reg = MetricsRegistry()
    wd = SloWatchdog(default_serving_rules(deadline_ms=SERVE_DEADLINE_MS),
                     registry=reg)

    t0 = time.perf_counter()
    engine = ServingEngine(predict, None, images.shape[1:], np.uint8,
                           buckets=buckets, max_wait_ms=20.0, depth=2,
                           tracer=SpanTracer(None), metrics=reg, watchdog=wd)
    rec = dict(build_s=time.perf_counter() - t0, buckets={})
    want = want_replay(cfg, torch.bfloat16)
    for b in buckets:
        got = replay_launches(engine.runners[b])
        got = {k: got.get(k, 0) for k in want}
        require(got == want, "serve_int8 bucket %d: launches per replay %s, "
                "want %s" % (b, got, want))
        rows = serve_group(engine, images[:b])
        eager = [tuple(t[i].cpu().numpy() for t in predict(images[:b]))
                 for i in range(b)]
        same = [rows_equal(r, e) for r, e in zip(rows, eager)]
        require(all(same), "serve_int8 bucket %d: %d of %d rows differ from "
                "the eager int8 predict" % (b, same.count(False), b))
        rec["buckets"][b] = dict(capture_s=engine.runners[b].build_s,
                                 nodes=graph_nodes(engine.runners[b].graph))
    rec["launches"] = want
    closed = loadgen.closed_loop(engine, images, 64, 2.0)
    closed["alerts"] = [a["rule"] for a in wd.alerts]
    rec["closed"] = closed
    rec["open"] = {}
    for share in (0.5, 0.9):
        rate = share * closed["goodput_rps"]
        sched = loadgen.arrival_schedule(rate, 3.0, seed=int(share * 100))
        n_alerts = len(wd.alerts)
        r = loadgen.open_loop(engine, images, sched, 3.0,
                              SERVE_DEADLINE_MS / 1e3, rate)
        r["alerts"] = [a["rule"] for a in wd.alerts[n_alerts:]]
        r["state"] = engine.state
        rec["open"][share] = r
    by_name, traced = trace_device_ms(
        lambda i: loadgen.closed_loop(engine, images, 64, 0.5), reps=1)
    busy = sum(by_name.values())
    rec["idle"] = max(0.0, 1 - busy / traced) if busy else None
    rec["busy_ms"], rec["traced_ms"] = busy, traced
    health = engine.health()
    require("alerts" in health and engine.stats()["failed"] == 0,
            "serve_int8: health %s, stats %s" % (sorted(health),
                                                 engine.stats()))
    # hot reload: other weights and rescaled clip ranges, into the same
    # storages
    twin = predict.model
    ptrs = [t.data_ptr() for t in list(twin.parameters())
            + list(twin.buffers())]
    before = serve_group(engine, images[:16])
    fresh = perturb_bn(load_eval_state(cfg), seed=5)
    scales2 = scale_tree(scales, 1.25)
    engine.reload(fresh.state_dict(), scales=scales2)
    after = serve_group(engine, images[:16])
    from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
    with serve_engine(make_predict_fn(fresh, cfg, normalize="imagenet",
                                      quant_scales=scales2), images, (16,),
                      max_wait_ms=20.0, depth=2) as other:
        want_rows = serve_group(other, images[:16])
    kept = ptrs == [t.data_ptr() for t in list(twin.parameters())
                    + list(twin.buffers())]
    changed = sum(not rows_equal(a, b) for a, b in zip(after, before))
    require(kept and changed > 0
            and all(rows_equal(a, b) for a, b in zip(after, want_rows))
            and engine.stats()["bucket_builds"] == len(buckets),
            "serve_int8 reload: storages kept %s, rows changed %d, rows "
            "equal to a fresh engine's %s, bucket builds %d" % (
                kept, changed,
                [rows_equal(a, b) for a, b in zip(after, want_rows)],
                engine.stats()["bucket_builds"]))
    rec["reload"] = dict(changed=changed)
    engine.close()
    rec["eval"] = int8_eval(cfg)
    state["serve_int8"] = rec
    log("serve_int8 (--tier throughput, bf16): engine built in %.2f s; "
        "per bucket capture s / graph nodes: %s; launches per replay "
        "(profiler, every bucket) %s; rows bit-equal to the eager int8 "
        "predict at each batch size" % (
            rec["build_s"], ", ".join(
                "b%d %.3f / %s" % (b, r["capture_s"], r["nodes"])
                for b, r in rec["buckets"].items()),
            {k: v for k, v in want.items() if v}))
    log("serve_int8: closed loop (64 clients, %.1f s) %.1f img/s, p50 "
        "%.3f ms, p99 %.3f ms; alerts %s; idle share of a saturated window "
        "%s (device busy %.2f ms of a traced %.2f ms)" % (
            closed["duration_s"], closed["goodput_rps"], closed["p50_ms"],
            closed["p99_ms"], closed["alerts"] or "none",
            "not measured (no device time)" if rec["idle"] is None
            else "%.1f%%" % (100 * rec["idle"]), rec["busy_ms"],
            rec["traced_ms"]))
    for share, r in rec["open"].items():
        log("serve_int8: open loop at %d%% (%.1f req/s offered, %d "
            "arrivals, deadline %.0f ms): goodput %.1f img/s, p50 %s ms, "
            "p99 %s ms, on time %d, late %d, shed %d, lost %d; alerts %s; "
            "state %s" % (100 * share, r["offered_rps"], r["n"],
                          r["deadline_ms"], r["goodput_rps"], r["p50_ms"],
                          r["p99_ms"], r["ontime"], r["late"], r["shed"],
                          r["lost"], r["alerts"] or "none", r["state"]))
    e = rec["eval"]
    log("serve_int8: reload of other weights and x1.25 scales kept every "
        "storage, %d of 16 rows changed, all equal to a fresh engine's; "
        "eval --tier throughput on 16 images: mAP %.4f through the engine, "
        "calibration saved (sha256 %s), all %d detections equal to eager "
        "int8 predicts with the saved scales"
        % (changed, e["map"], e["sha256"][:12], e["detections"]))


# ------------------------------------ fleet, cascade, streams (serving.runs)

# each run's load loops, seconds
RUN_SECONDS = 1.5


def runs_args(*argv):
    """`serving.runs` options of the real-engine phases: the card, the
    flagship bf16 at 512^2, 64 clients, 8 images, a 2 ms batching wait,
    streams offered twice their capacity, no span log, the given mode."""
    from real_time_helmet_detection_tpu_torch.serving import runs
    return runs.parse_args(
        list(argv) + ["--infer-dtype", "bf16", "--clients", "64", "--pool",
                      "8", "--max-wait-ms", "2", "--stream-load", "2",
                      "--trace-exemplars", "0", "--duration",
                      str(RUN_SECONDS)])


def replay_inspector(launches, labels):
    """An `inspect` hook for `serving.runs`: for each configuration in
    `labels`, the first replica's launches per replay of every bucket
    (profiler), required equal to `want_replay`; recorded in
    `launches[label]`."""
    import torch

    def inspect(label, cfg, engines):
        if label not in labels:
            return
        want = want_replay(cfg, torch.bfloat16 if cfg.amp else torch.float32)
        for b, runner in sorted(engines[0].runners.items()):
            got = replay_launches(runner)
            got = {k: got.get(k, 0) for k in want}
            require(got == want, "%s bucket %d: launches per replay %s, "
                    "want %s" % (label, b, got, want))
        launches[label] = {k: v for k, v in want.items() if v}
    return inspect


def path_counts(what, need):
    """The launch counters since the last `reset_counts`, required above
    zero for each kernel of the path in `need`."""
    counts = read_counts()
    require(all(counts[k] > 0 for k in need), "%s: kernels of the path "
            "launched no time: %s" % (what, {k: counts[k] for k in need}))
    return {k: v for k, v in counts.items() if v}


def rows_all(rec, what):
    require(rec["rows"] > 0 and rec["equal"] == rec["rows"],
            "%s: %d of %d rows equal the eager predict at their bucket; "
            "first misses %s" % (what, rec["equal"], rec["rows"],
                                 rec.get("misses")))


def phase_fleet(state):
    """The fleet over real engines (`serving.runs.fleet_engine_run`, the
    `engine` section of the fleet record): flagship bf16 replicas
    on the card, buckets 1-16, each with its own model and graphs. Closed
    loops of 64 clients at 1 and 2 replicas (images/s, p50/p99), their
    rows bit-equal to the eager predict at the bucket that served each;
    skewed load (replica 0 pinned busy) routes all to replica 1, a tenant
    over its budget sheds alone; a seeded fleet:replica worker-death in a
    closed loop of 64: lost 0, one respawn that builds each bucket once,
    rows still bit-equal; a canary rollout of perturbed weights at 0.25
    promotes and every replica then serves the new weights' rows; a
    rollback on the canary's error burn (faults on the canary only)
    restores the old rows. Launches per replay of every bucket (profiler)
    against `expected_launches`; the wrappers' counts over the phase."""
    import torch
    from real_time_helmet_detection_tpu_torch.serving import runs
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    out = runs.fleet_engine_run(runs_args("--replicas", "1", "2"),
                                replay_inspector(launches, {"fleet x1"}))
    out["counts"] = path_counts("fleet", ("peak_scores", "bn_act",
                                          "bn_add_act"))
    out["launches"] = launches
    nb = len(out["buckets"])
    for row in out["rows"]:
        rows_all(row["rows"], "fleet x%d" % row["replicas"])
        require(row["lost"] == 0 and row["builds"] == [nb] * row["replicas"],
                "fleet x%d: lost %d, builds %s" % (row["replicas"],
                                                   row["lost"], row["builds"]))
    r = out["routing"]
    rows_all(r["rows"], "fleet routing")
    require(r["b_replicas"] == [[1]] * 6 and r["a_shed"] == 3
            and r["a_tenant_shed"] == 3 and r["tenants"]["b"]["shed"] == 0
            and r["tenants"]["bulk"]["shed"] == 0,
            "fleet routing: replicas of the unpinned requests %s, tenant a "
            "shed %d (%d by its budget), tenants %s" % (
                r["b_replicas"], r["a_shed"], r["a_tenant_shed"],
                r["tenants"]))
    d = out["death"]
    rows_all(d["after"], "fleet after the death")
    require(len(d["fired"]) == 1 and d["lost"] == 0 and d["deaths"] == 1
            and d["respawns"] == 1 and d["builds"] == [nb, nb]
            and sorted(d["generations"]) == [0, 1],
            "fleet death: fired %s, lost %d, deaths %d, respawns %d, builds "
            "%s, generations %s" % (d["fired"], d["lost"], d["deaths"],
                                    d["respawns"], d["builds"],
                                    d["generations"]))
    p, b = out["promote"], out["rollback"]
    rows_all(p["after"], "fleet after the promote")
    rows_all(b["after"], "fleet after the rollback")
    require(p["outcome"] == "promoted" and p["lost"] == 0
            and p["after"]["replicas"] == [0, 1],
            "fleet promote: %s, lost %d, replicas %s" % (
                p["outcome"], p["lost"], p["after"]["replicas"]))
    require(b["outcome"] == "rolled-back"
            and "canary-error-burn" in b["alerts"]
            and b["lost_acks"] == 0 and b["lost"] == 0
            and b["during_equal"] == b["during"] - b["shed"]
            and b["after"]["replicas"] == [0, 1],
            "fleet rollback: %s on %s, lost %d/%d, %d of %d served rows "
            "the old or new weights', replicas after %s (states %s)" % (
                b["outcome"], b["alerts"], b["lost_acks"], b["lost"],
                b["during_equal"], b["during"] - b["shed"],
                b["after"]["replicas"], b["states"]))
    state["fleet"] = out
    rates = {row["replicas"]: row["loop"] for row in out["rows"]}
    log("fleet: closed loops of 64: x1 %.1f img/s (p50 %.3f, p99 %.3f ms), "
        "x2 %.1f img/s (p50 %.3f, p99 %.3f ms), x2/x1 %.3f; launches per "
        "replay (profiler, every bucket) %s; peak memory %s GB; engine "
        "builds %s s" % (
            rates[1]["goodput_rps"], rates[1]["p50_ms"], rates[1]["p99_ms"],
            rates[2]["goodput_rps"], rates[2]["p50_ms"], rates[2]["p99_ms"],
            rates[2]["goodput_rps"] / rates[1]["goodput_rps"],
            out["launches"]["fleet x1"], out["peak_gb"],
            ", ".join("%.2f" % x for x in out["engine_build_s"])))
    log("fleet death %s: lost 0, 1 respawn built in %s s, %d re-dispatched; "
        "the loop %.1f img/s, p50 %.3f, p99 %.3f ms; promote after %d "
        "canary completions, rollback on %s with %d of %d requests shed"
        % (d["fired"], ", ".join("%.2f" % x for x in d["respawn_build_s"]),
           d["redispatched"], d["loop"]["goodput_rps"], d["loop"]["p50_ms"],
           d["loop"]["p99_ms"], p["observed"], b["alerts"], b["shed"],
           b["during"]))


def phase_cascade(state):
    """The cascade over real engines (`serving.runs.cascade_engine_run`,
    the `engine` section of the cascade record): an edge-tier
    engine (ghost 64, buckets 1/2/4) predicting with the confidence, in
    front of a quality-tier engine (2 stacks, soft-NMS), bf16 512^2, at
    the calibrated threshold (`cascade_overrides()`). The graph's
    confidence equals `confidence_summary` of its rows on the host bit
    for bit; tier-pinned rows and cascade answers equal the answering
    tier's eager predict at their bucket, escalation follows the
    confidence; an injected fleet:escalate fault degrades to the edge
    answer, a quality replica's death during escalation still delivers.
    Launches per replay of both engines (the confidence adds none of
    ours); escalation rate, images/s and p50/p99 of a closed loop."""
    from real_time_helmet_detection_tpu_torch.config import \
        cascade_overrides
    from real_time_helmet_detection_tpu_torch.serving import runs
    reset_counts()
    launches = {}
    out = runs.cascade_engine_run(
        runs_args("--cascade"),
        replay_inspector(launches, {"cascade edge", "cascade quality"}))
    out["counts"] = path_counts("cascade", ("peak_scores", "bn_act",
                                            "bn_add_act"))
    out["launches"] = launches
    over = cascade_overrides()
    require(out["threshold"] == over["cascade_threshold"],
            "cascade threshold %r" % out["threshold"])
    log("cascade threshold %g from %s" % (out["threshold"], over["_source"]))
    edge, quality = out["pinned"]["edge"], out["pinned"]["quality"]
    rows_all(edge, "cascade edge rows")
    rows_all(quality, "cascade quality rows")
    require(edge["confidence_equal"] == edge["rows"],
            "cascade: %d of %d confidences equal the host's"
            % (edge["confidence_equal"], edge["rows"]))
    c = out["cascade"]
    rows_all(c, "cascade answers")
    require(c["follows_threshold"] == c["rows"] and out["lost"] == 0
            and out["builds"] == [3, 5], "cascade: %d of %d follow the "
            "threshold, lost %d, builds %s" % (c["follows_threshold"],
                                                c["rows"], out["lost"],
                                                out["builds"]))
    f = out["faults"]
    require(f["lost_acks"] == 0 and f["lost"] == 0 and f["degraded"] == 1
            and f["degraded_equal"] == 1
            and f["quality_equal"] == f["requests"] - 1
            and f["deaths"] == 1 and f["respawns"] == 1
            and f["builds"] == [3, 5], "cascade faults: %s" % f)
    state["cascade"] = out
    loop = out["loop"]
    log("cascade at threshold %g: escalation rate %.4f (%d of %d resolved "
        "at the edge in the checked burst); closed loop of 64 through the "
        "cascade tenant %.1f img/s, p50 %.3f, p99 %.3f ms; launches per "
        "replay %s; faults %s: 1 degraded to the edge row, the quality "
        "respawn built in %s s, lost 0; peak memory %s GB" % (
            out["threshold"], out["escalation_rate"], c["resolved"],
            c["rows"], loop["goodput_rps"], loop["p50_ms"], loop["p99_ms"],
            launches, f["fired"],
            ", ".join("%.2f" % x for x in f["respawn_build_s"]),
            out["peak_gb"]))


def phase_streams(state):
    """Streaming video over real engines (`serving.runs.
    streams_engine_run`, the `engine` section of the streams record): 4
    seeded streams of 1024^2 uint8 frames (2 x 2 tiles of 512^2) at
    redundancy 0.75 through sessions over an edge-tier engine, at the
    calibrated threshold (`stream_overrides()`). The card's tile delta
    summary equals the CPU's on every frame pair; a first frame computes
    every tile and its copy none; an all-changed frame's stitched answer
    equals the eager predict of each tile; frames deliver in order;
    dropped, corrupt and late frames and a failed tile deliver from the
    cache. Frames/s gated and ungated at the same offered rate, the skip
    rate."""
    from real_time_helmet_detection_tpu_torch.config import stream_overrides
    from real_time_helmet_detection_tpu_torch.obs.spans import SpanTracer
    from real_time_helmet_detection_tpu_torch.serving import runs
    reset_counts()
    launches = {}
    # the fault run's stream records, for phase report
    tracer = SpanTracer(os.path.join(round_dir(state), "obs",
                                     "streams_spans.jsonl"))
    try:
        out = runs.streams_engine_run(runs_args("--streams"),
                                      replay_inspector(launches,
                                                       {"streams edge"}),
                                      tracer=tracer)
    finally:
        tracer.close()
    out["counts"] = path_counts("streams", ("peak_scores", "bn_act"))
    out["launches"] = launches
    over = stream_overrides()
    require(out["threshold"] == over["stream_threshold"],
            "streams threshold %r" % out["threshold"])
    log("streams threshold %g from %s" % (out["threshold"], over["_source"]))
    require(out["delta"]["equal"] == out["delta"]["pairs"] > 0,
            "streams: the card's delta equals the CPU's on %d of %d pairs"
            % (out["delta"]["equal"], out["delta"]["pairs"]))
    g = out["gating"]
    require((g["first_computed"], g["copy_computed"], g["changed_computed"])
            == (4, 0, 4) and g["copy_same"]
            and g["first_oracle"] == g["changed_oracle"] == 4,
            "streams gating: %s" % g)
    require(out["in_order"] and out["builds"] == [3]
            and all(a["lost"] == 0 for a in out["arms"].values()),
            "streams: in order %s, builds %s, lost %s" % (
                out["in_order"], out["builds"],
                [a["lost"] for a in out["arms"].values()]))
    f = out["faults"]
    require(f["lost"] == 0 and f["in_order"] and f["delivered"] == 10
            and (f["gaps"], f["corrupt"], f["late"]) == (2, 1, 1)
            and f["degraded_tiles"] > 0, "streams faults: %s" % f)
    state["streams"] = out
    a = out["arms"]
    log("streams: 4 x 1024^2 at redundancy 0.75, threshold %g: ungated "
        "capacity %.1f frames/s; at %.1f offered, gated %.1f vs ungated %.1f "
        "frames/s on time (x%.3f; p50 %s vs %s ms, p99 %s vs %s ms), tile "
        "skip rate %.4f; delta card = CPU on %d pairs; launches per replay "
        "%s; faults %s delivered from the cache (%d tiles degraded)" % (
            out["threshold"], out["capacity_ungated"]["goodput_fps"],
            out["offered_fps"], a["gated"]["goodput_fps"],
            a["ungated"]["goodput_fps"], out["goodput_ratio"],
            a["gated"]["p50_ms"], a["ungated"]["p50_ms"],
            a["gated"]["p99_ms"], a["ungated"]["p99_ms"],
            out["tile_skip_rate"], out["delta"]["pairs"], launches,
            f["fired"], f["degraded_tiles"]))


# serve_bench's engine mode at the flagship's full width: bf16 512^2,
# buckets 1-16, 64 clients, 1 s loops, a device loss at the 9th dispatch
# and a hung fetch at the 20th, the 3 slowest requests' waterfalls
SERVE_BENCH_ARGS = (
    "--device", "cuda", "--infer-dtype", "bf16", "--imsize", "512",
    "--inch", "128", "--buckets", "1", "2", "4", "8", "16", "--clients",
    "64", "--duration", "1", "--loads", "0.5", "0.9", "2.0", "--faults",
    "serve:dispatch=device-loss@9,serve:fetch=hung-fetch@20",
    "--trace-exemplars", "3")
# its simulated sections: fleet rows at 1, 2 and 4 replicas, the cascade
# and streams comparisons, 1 s loops, 512^2 images (1024^2 frames)
SERVE_SIM_ARGS = ("--device", "cuda", "--imsize", "512", "--duration", "1",
                  "--replicas", "1", "2", "4", "--trace-exemplars", "0")


def phase_serve_bench(state):
    """serve_bench on the card (`serving.runs`, the port of
    scripts/serve_bench.py): engine mode (`run_bench`, SERVE_BENCH_ARGS)
    — the serial bucket-1 server's capacity, the engine's closed loop
    and open loops at 0.5/0.9/2.0 of it under the injected faults, the
    serial server on the overload trace; every answered row bit-equal
    (NaN-aware) to the eager predict at the bucket that served it, lost 0
    in every row, a retry, each bucket's launches per replay against
    `expected_launches` (profiler, the `inspect` hook), the trace
    summary with no orphan and no broken chain. Then the simulated
    sections called directly (the real canary, death and cascade runs
    are phases fleet and cascade): fleet rows at N = 1/2/4, the cascade
    against all-quality with its escalations against the host oracle,
    the streams arms, both sim fault runs, lost 0 everywhere. Then the
    selfcheck on the card, ok with no failure."""
    from real_time_helmet_detection_tpu_torch.obs.spans import SpanTracer
    from real_time_helmet_detection_tpu_torch.serving import runs
    from real_time_helmet_detection_tpu_torch.serving.selfcheck import \
        selfcheck
    t0 = time.time()
    reset_counts()
    launches = {}
    eng = runs.run_bench(runs.parse_args(SERVE_BENCH_ARGS),
                         replay_inspector(launches, {"engine"}))
    counts = path_counts("serve_bench", ("peak_scores", "bn_act",
                                         "bn_add_act"))
    t_engine = time.time() - t0
    curve, f = eng["curve"], eng["faults"]
    require(all(r["lost"] == 0 for r in curve) and f["lost_acks"] == 0,
            "serve_bench: lost %s, lost acks %d" % (
                [r["lost"] for r in curve], f["lost_acks"]))
    require(eng["retried"] >= 1 and f["injected"]["total"] == 2,
            "serve_bench: retried %d, injected %s" % (eng["retried"],
                                                       f["injected"]))
    rows_all(eng["rows_check"], "serve_bench engine rows")
    require(eng["bucket_builds"] == len(eng["buckets"]),
            "serve_bench: %d captures for %d buckets" % (
                eng["bucket_builds"], len(eng["buckets"])))
    ts = eng["trace_summary"]
    require(ts["orphans"] == 0 and ts["broken_chains"] == 0
            and ts["request_traces"] > 0 and eng["gate_traces_complete"],
            "serve_bench traces: %d request traces, %d orphans, %d broken "
            "chains" % (ts["request_traces"], ts["orphans"],
                        ts["broken_chains"]))
    t1 = time.time()
    sargs = runs.parse_args(SERVE_SIM_ARGS)
    off = SpanTracer(None)
    fleet = runs.fleet_scaling_rows(sargs, off)
    casc = runs.cascade_sim_rows(sargs, off)
    casc_faults = runs.cascade_fault_run(sargs, off)
    streams = runs.streams_sim_arms(sargs, off)
    stream_faults = runs.stream_fault_run(sargs, off)
    t_sims = time.time() - t1
    sim_rows = fleet + casc["rows"] + streams["rows"]
    require(all(r["lost"] == 0 for r in sim_rows)
            and casc_faults["lost_acks"] == 0
            and stream_faults["lost_acks"] == 0,
            "serve_bench sims: lost %s, fault runs' lost acks %d, %d" % (
                [r["lost"] for r in sim_rows], casc_faults["lost_acks"],
                stream_faults["lost_acks"]))
    e = casc["escalations"]
    require(e["answered"] > 0 and e["agree"] == e["answered"]
            and e["escalated"] == e["oracle"],
            "serve_bench cascade sim: escalations %s" % e)
    t2 = time.time()
    sc = selfcheck("cuda")
    t_self = time.time() - t2
    require(sc["ok"] and sc["failures"] == [],
            "serve_bench selfcheck: failures %s" % sc["failures"])
    state["serve_bench"] = dict(
        engine=eng, counts=counts, launches=launches, fleet_rows=fleet,
        cascade=casc, cascade_faults=casc_faults, streams=streams,
        stream_faults=stream_faults, selfcheck=sc,
        walls=dict(engine=t_engine, sims=t_sims, selfcheck=t_self))
    log("serve_bench engine (bf16 512^2, buckets 1-16, tracing on): serial "
        "b1 %.1f req/s, engine capacity %.1f req/s (closed loop of 64), "
        "curve %s; goodput vs serial at 2x %.3f (gate_3x %s), serial at 2x "
        "%.1f req/s; faults %s, retried %d, lost 0; %d of %d rows equal "
        "the eager predict; launches per replay %s; %d request traces, "
        "exemplar p99 stage %s, stage shares %s; mean batch fill %s, shed "
        "%d, alerts %s" % (
            eng["serial_b1_rps"], eng["engine_capacity_rps"],
            [(r["load_multiplier"], round(r["goodput_rps"], 1),
              r["p50_ms"], r["p99_ms"], r["shed"]) for r in curve],
            eng["goodput_vs_serial_at_overload"], eng["gate_3x"],
            eng["serial_overload"]["goodput_rps"], f["spec"],
            eng["retried"], eng["rows_check"]["equal"],
            eng["rows_check"]["rows"], launches, ts["request_traces"],
            eng.get("exemplar_p99_stage"), ts["stage_shares"],
            eng["mean_batch_fill"],
            eng["shed_total"], eng["slo_alerts"]))
    log("serve_bench sims (512^2): fleet rows %s; cascade %.1f vs "
        "all-quality %.1f req/s (x%.3f, escalation rate %.4f, %d of %d "
        "escalations the host oracle's); streams gated %.1f vs full %.1f "
        "frames/s (x%.3f, computed tile fraction %.4f); fault runs lost 0"
        % ([(r["replicas"], round(r["goodput_rps"], 1),
             round(r["scaling_eff"], 4)) for r in fleet],
           casc["rows"][0]["goodput_rps"], casc["rows"][1]["goodput_rps"],
           casc["cascade_goodput_ratio"], casc["escalation_rate"],
           e["agree"], e["answered"], streams["rows"][0]["goodput_fps"],
           streams["rows"][1]["goodput_fps"],
           streams["stream_goodput_ratio"],
           streams["computed_tile_fraction"]))
    log("serve_bench selfcheck on the card: %d failures, %.1f s; walls: "
        "engine %.1f s, sims %.1f s, selfcheck %.1f s" % (
            len(sc["failures"]), sc["elapsed_s"], t_engine, t_sims, t_self))


# ------------------------------------------- the run's round, quality, report

def round_dir(state):
    """This run's round directory (`obs/`, `queue/`): what phases write
    for phase report; `main` removes it at the end."""
    if "round_dir" not in state:
        state["round_dir"] = tempfile.mkdtemp(prefix="chip_smoke_round_")
        for sub in ("obs", "queue"):
            os.makedirs(os.path.join(state["round_dir"], sub))
    return state["round_dir"]


def drop_round(state):
    if "round_dir" in state:
        shutil.rmtree(state.pop("round_dir"), ignore_errors=True)


def keep_round_files(state, files):
    """Copy {path: name in the round dir} before a phase's temp dir goes."""
    for src, rel in files.items():
        shutil.copyfile(src, os.path.join(round_dir(state), rel))


# the quality matrix's configuration on the card: JAX's smoke sizes at the
# tiers' real widths, 2 epochs of 16 images (4 steps), 8 held out
QUALITY_ARGS = ("--smoke", "--width-scale", "1", "--epochs", "2",
                "--train", "16", "--test", "8")
# 4 videos of 4 frames: the sweep's host mAP over 16 frames, not 64
QUALITY_VIDEO = ("--frames", "4", "--seqs", "4")
QUALITY_KERNELS = ("peak_scores", "bn_act", "bn_add_act", "bn_stats",
                   "bn_bwd_sums", "bn_add_bwd_sums", "bn_bwd_dx",
                   "bn_add_bwd_dx", "loss_fwd", "loss_bwd", "quantize_act",
                   "qconv_dense", "qconv_dw")


def phase_quality(state):
    """The quality matrix on the card (`quality.matrix`): `--tiers`,
    `--cascade` and `--streams` at QUALITY_ARGS in a temp dir, its flight
    recorder on the round's `obs/quality_spans.jsonl`. Every kernel of the
    trainings, evals and int8 eval launched; one eval predict of each tier
    (the throughput tier's also int8) counted by kernel name in a
    profiler trace against `want_replay`; the records' platform and card;
    the cascade sweep's escalation rate non-decreasing in the threshold,
    its ends the all-edge and all-quality mAPs; the stream sweep at 0
    equal to full inference; calibration/ untouched; the served
    thresholds' `_source`."""
    import torch
    from real_time_helmet_detection_tpu_torch.config import (
        cascade_overrides, stream_overrides)
    from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state
    from real_time_helmet_detection_tpu_torch.ops.quant import load_scales
    from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
    from real_time_helmet_detection_tpu_torch.quality import matrix
    calib = sorted(os.listdir(matrix.CALIBRATION_DIR)) \
        if os.path.isdir(matrix.CALIBRATION_DIR) else []
    saved = os.environ.get("OBS_SPAN_LOG")
    os.environ["OBS_SPAN_LOG"] = os.path.join(round_dir(state), "obs",
                                              "quality_spans.jsonl")
    reset_counts()
    walls = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_quality_") as tmp:
        common = list(QUALITY_ARGS) + ["--work-dir", tmp]
        try:
            out = {}
            for mode in ("tiers", "cascade", "streams"):
                t0 = time.time()
                out[mode] = matrix.main(["--" + mode] + common + (
                    list(QUALITY_VIDEO) if mode == "streams" else []))
                walls[mode] = time.time() - t0
        finally:
            if saved is None:
                os.environ.pop("OBS_SPAN_LOG", None)
            else:
                os.environ["OBS_SPAN_LOG"] = saved
        counts = path_counts("quality", QUALITY_KERNELS)
        run = matrix.Run(matrix.build_parser().parse_args(
            ["--tiers"] + common))
        images, _ = run.held_out()
        image = images[0][None]
        traced = {}
        for name in ("edge", "throughput", "quality"):
            cfg, predict = run.predict_of(name, run.save_of(name))
            traced[name] = (cfg, predict)
        save = run.save_of("throughput")
        cfg8 = run.eval_config("throughput", save, infer_dtype="int8")
        scales = load_scales(os.path.join(save, "calibration",
                                          "quant_scales.json"))
        traced["throughput int8"] = (cfg8, make_predict_fn(
            load_eval_state(cfg8, run.device), cfg8,
            normalize=cfg8.pretrained, device=run.device,
            quant_scales=scales))
        launches = {}
        for label, (cfg, predict) in traced.items():
            want = want_replay(cfg, torch.float32)
            predict(image)  # warm: cuDNN's first call of a shape
            # a trace short of the counters' launches is taken again
            got, _ = program_launches(predict, image)
            got = {k: got.get(k, 0) for k in want}
            require(got == want, "quality: %s predict launches %s, want %s"
                    % (label, got, want))
            launches[label] = {k: v for k, v in want.items() if v}
    tiers = out["tiers"]
    require(tiers["tier_meta"]["platform"] == "gpu"
            and tiers["device"]["name"] == state["kind"]
            and all(out[m]["platform"] == "gpu" for m in ("cascade",
                                                          "streams")),
            "quality: records' platform %s / %s / %s, card %s" % (
                tiers["tier_meta"]["platform"], out["cascade"]["platform"],
                out["streams"]["platform"], tiers["device"]))
    require(set(tiers["tiers"]) == set(matrix.TIER_ROWS)
            and all(math.isfinite(r["mAP"]) for r in tiers["tiers"].values()),
            "quality: tier rows %s" % tiers["tiers"])
    c = out["cascade"]
    rates = [r["escalation_rate"] for r in c["sweep"]]
    require(rates == sorted(rates) and rates[-1] == 1.0
            and c["sweep"][0]["blended_mAP"] == c["all_edge_mAP"]
            and c["sweep"][-1]["blended_mAP"] == c["all_quality_mAP"],
            "quality: cascade sweep %s, all-edge %s, all-quality %s" % (
                c["sweep"], c["all_edge_mAP"], c["all_quality_mAP"]))
    st = out["streams"]
    first = st["sweep"][0]
    require(first["threshold"] == 0.0 and first["tile_skip_rate"] == 0.0
            and first["blended_video_mAP"] == st["full_video_mAP"],
            "quality: stream sweep at 0 %s, full %s" % (first,
                                                        st["full_video_mAP"]))
    now = sorted(os.listdir(matrix.CALIBRATION_DIR)) \
        if os.path.isdir(matrix.CALIBRATION_DIR) else []
    require(now == calib, "quality: calibration/ %s -> %s" % (calib, now))
    sources = (cascade_overrides()["_source"], stream_overrides()["_source"])
    state["quality"] = dict(walls=walls, counts=counts, launches=launches,
                            sources=sources)
    rows = tiers["tiers"]
    log("quality: --tiers %.1f s, --cascade %.1f s, --streams %.1f s; "
        "mAP quality %.4f, edge %.4f (scratch %.4f), throughput int8 %.4f "
        "(float %.4f); b1 p50/p99 ms edge %s/%s, throughput %s/%s, quality "
        "%s/%s; GFLOPs %s / %s / %s" % (
            walls["tiers"], walls["cascade"], walls["streams"],
            rows["quality"]["mAP"], rows["edge"]["mAP"],
            rows["edge_scratch"]["mAP"], rows["throughput"]["mAP"],
            rows["throughput"]["map_bf16"],
            rows["edge"]["serve_wire_ms_b1"],
            rows["edge"]["serve_wire_p99_ms_b1"],
            rows["throughput"]["serve_wire_ms_b1"],
            rows["throughput"]["serve_wire_p99_ms_b1"],
            rows["quality"]["serve_wire_ms_b1"],
            rows["quality"]["serve_wire_p99_ms_b1"],
            rows["edge"]["predict_gflops"],
            rows["throughput"]["predict_gflops"],
            rows["quality"]["predict_gflops"]))
    log("quality: cascade %d points, selected %s; streams %d points, "
        "selected %s; launches per traced predict %s; the path's counters "
        "%s" % (len(c["sweep"]), c["selected"], len(st["sweep"]),
                st["selected"], launches, counts))
    log("quality: served thresholds from %s (cascade) and %s (streams)"
        % sources)


def phase_report(state):
    """The round report (`obs.report`) over this run's round directory:
    the supervisor's span log, journal and metrics, the streams' fault
    run's records and the quality phase's span log, whichever ran. No
    orphan trace, no broken chain; the streams' 10 frames with 2 gaps
    and the jobs' final states where those phases ran."""
    from real_time_helmet_detection_tpu_torch.obs import report
    root = round_dir(state)
    logs = sorted(os.listdir(os.path.join(root, "obs")))
    require(any(n.endswith("spans.jsonl") for n in logs),
            "report: no span log in the round (%s)" % logs)
    out = os.path.join(root, "report")
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):  # its JSON line
        rc = report.main(["--round-dir", root, "--out", out])
    wall = time.time() - t0
    require(rc == 0, "report: exit %d" % rc)
    rep = report.read_report(os.path.join(out, "report.json"))
    trc = rep["traces"]
    require(trc is None or (trc["orphans"] == 0
                            and trc["broken_chains"] == 0),
            "report: %s orphan traces %s, %s broken chains %s" % (
                trc["orphans"], trc["orphan_ids"], trc["broken_chains"],
                trc["broken_detail"]))
    if "streams_spans.jsonl" in logs:
        stm = rep["streams"]
        require(stm is not None and stm["frames"] == 10 and stm["gaps"] == 2
                and stm["late"] == 1, "report: streams %s" % stm)
    if "supervisor_spans.jsonl" in logs:
        q = rep["queue"]
        require(q is not None and q["counts"] == {"done": 3, "failed": 1}
                and rep["metrics"] is not None,
                "report: queue %s, metrics %s" % (q, rep["metrics"]))
    state["report"] = dict(wall=wall, logs=logs)
    log("report: %d span logs (%s), %d records; traces %s (%s request, "
        "%s closed, 0 orphans, 0 broken chains); streams %s; queue %s; "
        "%.2f s" % (
            len(rep["spans"]["logs"]), ", ".join(logs),
            rep["spans"]["records"], trc and trc["traces"],
            trc and trc["request_traces"], trc and trc["closed"],
            rep["streams"] and {k: rep["streams"][k] for k in (
                "frames", "computed_tiles", "total_tiles", "gaps", "late")},
            rep["queue"] and rep["queue"]["counts"], wall))


# ------------------------------------------------------------------ export

# the configurations of phase export, at 512^2 with the uint8 wire: the
# flagship bf16 with --export-serve at buckets 1 and 16, and the
# throughput tier (int8)
EXPORT_RUNS = (
    ("flagship bf16", dict(batch_size=16, imsize=512, amp=True,
                           export_raw_input=True, export_serve=True,
                           serve_buckets=[1, 16]), 3),
    ("throughput int8", dict(tier="throughput", batch_size=16, imsize=512,
                             amp=True, export_raw_input=True), 4),
)
RUNNER_ITERS = 100  # frames of each of the runner's two passes
RUNNER_DEPTH = 4


def export_run(label, d):
    """(cfg, seeded model) of EXPORT_RUNS' `label`, and its
    `export_predict` into `d` with the phase's arguments, timed."""
    from real_time_helmet_detection_tpu_torch.config import (Config,
                                                             apply_tier)
    from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state
    from real_time_helmet_detection_tpu_torch.export import export_predict
    fields, seed = {l: (f, s) for l, f, s in EXPORT_RUNS}[label]
    cfg = apply_tier(Config(**fields))
    model = perturb_bn(load_eval_state(cfg), seed=seed)
    t0 = time.perf_counter()
    program, package = export_predict(cfg, out_dir=d, model=model,
                                      runner_batches=(1,))
    return cfg, model, program, package, time.perf_counter() - t0


def export_worker(label, d):
    """`--export-worker`: one EXPORT_RUNS export in a process of its own
    at the lowest CPU priority, beside the run's other phases and the
    other export (`start_export_workers`); the first run's worker then
    builds the op library and the runner. Its paths, wall and g++
    seconds go to `d`/worker.json."""
    from torch._inductor.async_compile import shutdown_compile_workers
    from real_time_helmet_detection_tpu_torch.ops import _build
    from real_time_helmet_detection_tpu_torch.utils import save_json
    _, _, program, package, wall = export_run(label, d)
    shutdown_compile_workers()
    rec = {"program": program, "package": package, "export_wall_s": wall}
    if label == EXPORT_RUNS[0][0]:
        t0 = time.perf_counter()
        rec.update(cxx_s=_build.build_ops(),
                   build_s=time.perf_counter() - t0)
    save_json(os.path.join(d, "worker.json"), rec)


def start_export_workers():
    """The export root (in the ignored build/) and {label: Popen} of one
    `--export-worker` process per EXPORT_RUNS export, started now with
    the AOTInductor and Triton caches under build/; each logs to its
    dir's worker.log. They are `BACKGROUND` children until phase export
    waits for them."""
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    env = dict(os.environ)
    env.setdefault("TORCHINDUCTOR_CACHE_DIR", os.path.join(build,
                                                           "inductor"))
    env.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    root = tempfile.mkdtemp(prefix="export-", dir=build)
    workers = {}
    for label, _, _ in EXPORT_RUNS:
        d = os.path.join(root, label.split()[0])
        os.makedirs(d)
        with open(os.path.join(d, "worker.log"), "ab") as f:
            proc = subprocess.Popen(
                [sys.executable, os.path.join(REPO, "chip_smoke.py"),
                 "--export-worker", label, d], cwd=REPO, env=env,
                stdout=f, stderr=subprocess.STDOUT)
        workers[label] = proc
        BACKGROUND[proc.pid] = proc
    return root, workers


def stop_background():
    """Kill and reap the `BACKGROUND` children still running (a partial
    run that started the exports and skipped phase export)."""
    for pid, proc in list(BACKGROUND.items()):
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        BACKGROUND.pop(pid, None)


def phase_export_compile(state):
    """Start phase export's exports (`start_export_workers`): their
    AOTInductor compiles, CPU work at the lowest priority, run beside
    the phases that follow, which record no kernel time; phase export
    waits for them and checks what they wrote."""
    EXPORT_BG["root"], EXPORT_BG["workers"] = start_export_workers()
    log("export_compile: %d export workers started (%s)" % (
        len(EXPORT_BG["workers"]), ", ".join(
            "%s pid %d" % (l, p.pid)
            for l, p in EXPORT_BG["workers"].items())))


def program_launches(fn, x, attempts=3):
    """Our kernels' launches in one call of a reloaded program, counted by
    kernel name in a torch.profiler trace of it (`step_trace`, as
    `kernel_counts`), and by the launch counters of the same call. A
    trace that holds fewer of our kernels than the counters saw launched
    missed part of the call (the profiler has done so, see
    `replay_launches`) and is taken again, up to `attempts` times; the
    counts of the last trace are returned."""
    kinds = {c for _, c in TRACE_KERNELS}
    for attempt in range(attempts):
        names = step_trace(lambda: fn(x), before_active=reset_counts)
        traced, counted = kernel_counts(names), read_counts()
        seen = sum(n for k, n in traced.items() if k in kinds)
        launched = sum(n for k, n in counted.items() if k in kinds)
        if seen >= launched:
            break
        log("  a trace of the program held %d of the %d launches its "
            "counters saw (attempt %d of %d)" % (seen, launched, attempt + 1,
                                                 attempts))
    return traced, counted


def runner_rows(dets):
    """The runner's first-frame detections (per image [x1, y1, x2, y2,
    class, score]) as the Detections leaves `match_misses` reads."""
    import numpy as np
    import torch
    n = max([len(d) for d in dets] + [1])
    boxes = np.zeros((len(dets), n, 4), np.float32)
    classes = np.zeros((len(dets), n), np.int64)
    scores = np.zeros((len(dets), n), np.float32)
    valid = np.zeros((len(dets), n), bool)
    for i, rows in enumerate(dets):
        for j, r in enumerate(rows):
            boxes[i, j], classes[i, j], scores[i, j] = r[:4], r[4], r[5]
            valid[i, j] = True
    return [torch.from_numpy(a) for a in (boxes, classes, scores, valid)]


def op_host_us(state):
    """Host microseconds of issuing one call of each `helmet` op at a main
    path site (batch 1, 512^2), in two turns of opposite order: the
    public wrapper (checks, plan, the op through the dispatcher, the
    launch), the op called directly, and the route before the ops (the
    wrappers' code before this change: the same checks, the output, the
    variant or plan, the library, the stream and a direct `ctypes` call
    of the C entry)."""
    import torch
    from real_time_helmet_detection_tpu_torch.ops import (_build, epilogue,
                                                          peak, qconv,
                                                          residual)
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = channels_last(rand((1, 128, 128, 128), torch.bfloat16, gen))
    skip = channels_last(rand((1, 128, 128, 128), torch.bfloat16, gen))
    a = torch.rand(128, generator=gen, device="cuda") + 0.5
    b = torch.randn(128, generator=gen, device="cuda")
    logits = rand((1, 1, 128, 128, 6), torch.float32, gen, 3.0)
    tiles = peak.tiles(128, 128)[0] * peak.tiles(128, 128)[1]
    xq = channels_last(rand((1, 96, 256, 256), torch.bfloat16, gen))
    step = torch.tensor(0.02, device="cuda")
    q, wq, mult, bias = qconv_operands("dense", (1, 96, 256, 256), 96, 1,
                                       gen)
    qd, wd, md, bd = qconv_operands("dw", (1, 48, 256, 256), 48, 3, gen)
    plan = qconv.dense_plan(1, 256, 256, 96, 96, 1, 2)
    dw = qconv.dw_plan(1, 256, 256, 48)
    p = lambda t: t.data_ptr()  # noqa: E731
    ops = torch.ops.helmet
    stream = _build.stream_handle

    # the wrappers as they were before the ops: checks, output, variant or
    # plan, the library, the stream, the C entry through ctypes
    def old_peak():
        peak.check_pool_size(3)
        peak._check(logits, 2)
        o = torch.empty((1, 1, 2, 128, 128), device="cuda")
        v = peak.peak_variant(2, 6, 128, p(logits), p(o))
        _build.check(_build.load("peak").helmet_peak_scores(
            p(logits), p(o), 1, 2, 128, 128, 6, 1, tiles,
            int(v == "vector"), stream(logits.device)), "peak")
        return o

    def old_bn(skip_=None):
        epilogue.check_activation("ReLU")
        epilogue.check_layout("x", x)
        if skip_ is not None:
            epilogue.check_layout("skip", skip_, like=x)
        epilogue.check_vectors(x, eff_scale=a, eff_bias=b)
        epilogue.check_cuda("bn_act", x)
        o = torch.empty_like(x)
        if skip_ is not None:
            err = _build.load("residual").helmet_bn_add_act(
                p(x), p(a), p(b), p(skip_), p(o), x.numel(), 128, 1, 0,
                stream(x.device))
        else:
            v = epilogue.bn_act_variant(128, x.dtype, p(x), p(o))
            lib = _build.load("epilogue")
            entry = (lib.helmet_bn_act_vec if v == "vector"
                     else lib.helmet_bn_act)
            err = entry(p(x), p(a), p(b), p(o), x.numel(), 128, 1, 0,
                        stream(x.device))
        _build.check(err, "bn")
        return o

    def aligned(*ts):
        if any(p(t) % 16 for t in ts):
            raise ValueError("misaligned")

    def old_quant():
        qconv._check_act_input("x", xq, (torch.float32, torch.bfloat16))
        aligned(xq)
        o = torch.empty(xq.shape, dtype=torch.int8, device="cuda",
                        memory_format=torch.channels_last)
        _build.check(_build.load("qconv").helmet_quantize(
            p(xq), p(step), p(o), None, None, xq.numel(), 1,
            stream(xq.device)), "q")
        return o

    def old_dense():
        qconv._check_conv("conv_dense", q, wq, mult, bias, torch.bfloat16,
                          "Linear", 96)
        aligned(q, wq)
        o = torch.empty((1, 96, 256, 256), dtype=torch.bfloat16,
                        device="cuda", memory_format=torch.channels_last)
        pl = qconv.dense_plan(1, 256, 256, 96, 96, 1, 2)
        _build.check(_build.load("qconv").helmet_qconv_wgmma(
            p(q), p(wq), p(mult), p(bias), p(o), 1, 256, 256, 96, 96, 1,
            pl.box[1], pl.box[2], pl.n, pl.stages, 1, 2, None,
            stream(q.device)), "dense")
        return o

    def old_dw():
        qconv._check_conv("conv_dw", qd, wd, md, bd, torch.bfloat16,
                          "Linear", 48)
        aligned(qd, wd)
        o = torch.empty((1, 48, 256, 256), dtype=torch.bfloat16,
                        device="cuda", memory_format=torch.channels_last)
        pl = qconv.dw_plan(1, 256, 256, 48)
        _build.check(_build.load("qconv").helmet_qconv_dw_tile(
            p(qd), p(wd), p(md), p(bd), p(o), 1, 256, 256, 48, *pl.tile,
            pl.ct, 1, 2, None, stream(qd.device)), "dw")
        return o

    old_bn_act, old_bn_add_act = old_bn, lambda: old_bn(skip)
    calls = {
        "peak_scores": (lambda: peak.peak_scores(logits, 2),
                        lambda: ops.peak_scores.default(logits, 2, 3, tiles,
                                                        "auto"),
                        old_peak),
        "bn_act": (lambda: epilogue.bn_act(x, a, b, "ReLU"),
                   lambda: ops.bn_act.default(x, a, b, "ReLU", "auto"),
                   old_bn_act),
        "bn_add_act": (lambda: residual.bn_add_act(x, a, b, skip, "ReLU"),
                       lambda: ops.bn_add_act.default(x, a, b, skip, "ReLU"),
                       old_bn_add_act),
        "quantize_act": (lambda: qconv.quantize_act(xq, step),
                         lambda: ops.quantize_act.default(xq, step),
                         old_quant),
        "qconv_dense": (
            lambda: qconv.conv_dense(q, wq, mult, bias, torch.bfloat16),
            lambda: ops.qconv_dense.default(
                q, wq, mult, bias, 1, "Linear", plan.variant, plan.box[1],
                plan.box[2], plan.n, plan.stages), old_dense),
        "qconv_dw": (
            lambda: qconv.conv_dw(qd, wd, md, bd, torch.bfloat16),
            lambda: ops.qconv_dw.default(qd, wd, md, bd, 1, "Linear",
                                         dw.variant, *dw.tile, dw.ct),
            old_dw),
    }
    out = {}
    for name, (wrapper, op, old) in calls.items():
        t = {"wrapper": [], "op": [], "old": []}
        for order in (("wrapper", "op", "old"), ("old", "op", "wrapper")):
            for key in order:
                fn = {"wrapper": wrapper, "op": op, "old": old}[key]
                t[key].append(host_us(fn, iters=200))
        out[name] = {k: sum(v) / len(v) for k, v in t.items()}
    del x, skip, xq, q, qd
    torch.cuda.empty_cache()
    return out


def export_runs(state, out, root, images, image_file, runner, workers):
    """Each EXPORT_RUNS export of phase export and its checks: exported
    by its worker in `workers` (waited for here); `runner()` is the C++
    runner's path once it is built."""
    import torch
    from real_time_helmet_detection_tpu_torch.config import (Config,
                                                             apply_tier)
    from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state
    from real_time_helmet_detection_tpu_torch.export import (
        PROGRAM, RUNNER_PACKAGE, load_exported)
    from real_time_helmet_detection_tpu_torch.ops import quant
    from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
    dtype = torch.bfloat16
    for label, fields, seed in EXPORT_RUNS:
        d = os.path.join(root, label.split()[0])
        cfg = apply_tier(Config(**fields))
        model = perturb_bn(load_eval_state(cfg), seed=seed)
        t0 = time.perf_counter()
        rc = workers[label].wait(timeout=900)
        BACKGROUND.pop(workers[label].pid, None)
        waited = time.perf_counter() - t0
        done = os.path.join(d, "worker.json")
        with open(os.path.join(d, "worker.log"), "rb") as f:
            tail = f.read()[-4000:].decode(errors="replace")
        require(rc == 0 and os.path.exists(done), "%s: the export "
                "worker exited %d:\n%s" % (label, rc, tail))
        with open(done) as f:
            w = json.load(f)
        program, package = w["program"], w["package"]
        rec = dict(export_wall_s=w["export_wall_s"], waited_s=waited)
        if "cxx_s" in w:
            out.update(cxx_s=w["cxx_s"], build_s=w["build_s"])
            log("export: op library and runner built by the %s worker in "
                "%.1f s (g++ seconds: %s)" % (
                    label, w["build_s"], w["cxx_s"] or
                    "current builds found"))
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        require(package == os.path.join(d, RUNNER_PACKAGE)
                and meta["runner_package"] == RUNNER_PACKAGE,
                "%s: no runner package written" % label)
        scales = (quant.load_scales(os.path.join(d, meta["quant_scales_path"]))
                  if meta["quant_scales_path"] else None)
        predict = make_predict_fn(model, cfg, normalize="imagenet",
                                  quant_scales=scales)
        want = want_replay(cfg, dtype)
        programs = {1: program}
        for b in meta["serve_buckets"]:
            programs[b] = os.path.join(d, meta["serve_artifacts"]["b%d" % b],
                                       PROGRAM)
        require(sorted(programs) == sorted({1, *cfg.serve_buckets})
                if cfg.export_serve else list(programs) == [1],
                "%s: programs at batches %s" % (label, sorted(programs)))
        rec.update(aoti_compile_s=meta["aoti_compile_s"],
                   export_s=meta["export_s"],
                   pt2_mb={b: os.path.getsize(p) / 1e6
                           for b, p in programs.items()},
                   aoti_mb=os.path.getsize(package) / 1e6, batches={})
        for b, path in sorted(programs.items()):
            fn = load_exported(path)
            x = torch.from_numpy(images[:b]).cuda()
            got = fn(x)
            ref = predict(images[:b])
            same = [torch.equal(g, r) for g, r in zip(got, ref)]
            require(all(same), "%s b%d: the reloaded program's outputs "
                    "(boxes, classes, scores, valid) bit-equal to eager: %s"
                    % (label, b, same))
            traced, counted = program_launches(fn, x)
            traced = {k: traced.get(k, 0) for k in want}
            require(traced == want, "%s b%d: launches by kernel name %s, "
                    "want %s" % (label, b, traced, want))
            full = expected_launches(cfg, "predict", dtype)
            require(counted == full, "%s b%d: launch counters %s, want %s"
                    % (label, b, counted, full))
            rec["batches"][b] = dict(launches={k: v for k, v in
                                               traced.items() if v})
        # the runner, no Python: the program of batch 1 on image 0
        proc = subprocess.run(
            [runner(), d, "--image", image_file, "--iters",
             str(RUNNER_ITERS),
             "--depth", str(RUNNER_DEPTH)], capture_output=True, text=True,
            timeout=600)
        require(proc.returncode == 0, "%s: the runner exited %d:\n%s\n%s"
                % (label, proc.returncode, proc.stdout[-2000:],
                   proc.stderr[-4000:]))
        lines = [json.loads(line) for line in proc.stdout.splitlines()
                 if line.startswith("{")]
        dets = next(r for r in lines if "detections" in r)["detections"]
        stats = next(r for r in lines if "op_calls_per_frame" in r)
        x1 = torch.from_numpy(images[:1]).cuda()
        py = load_exported(program)(x1)
        with torch.inference_mode():  # the same package, loaded here
            pkg = torch._inductor.aoti_load_package(package)(x1)
        mine = runner_rows(dets)
        pairs = {}
        for tag, a, b in (("runner vs .pt2", mine, py),
                          ("runner vs package in Python", mine, pkg),
                          ("package in Python vs .pt2", pkg, py)):
            n1, miss1 = match_misses(a, b)
            n2, miss2 = match_misses(b, a)
            pairs[tag] = (n1 + n2, len(miss1) + len(miss2))
        log("export %s: detections >= 0.1 checked / without a match, both "
            "ways: %s" % (label, pairs))
        n, missed = pairs["runner vs .pt2"]
        require(not missed and n > 0, "%s: runner vs the Python program: "
                "%d detections >= 0.1, %d without a match"
                % (label, n, missed))
        n1 = n
        full = expected_launches(cfg, "predict", dtype)
        calls = stats["op_calls_per_frame"]
        derived = {k: full[k] for k in calls}
        require(calls == derived, "%s: the runner's op calls per frame %s, "
                "want %s" % (label, calls, derived))
        total = {k: v * stats["frames_total"] for k, v in derived.items()}
        require(stats["op_calls_total"] == total,
                "%s: the runner's op calls in all %s, want %s"
                % (label, stats["op_calls_total"], total))
        rec["runner"] = dict(matched=n1, pairs=pairs, **{
            k: stats[k] for k in ("load_ms", "latency_ms_depth1",
                                  "fps_depth1", "fps_depth", "depth",
                                  "op_calls_per_frame")})
        out[label] = rec
        serve = state.get("serve", {}).get(label, {})
        log("export %s: export wall %.1f s (trace + save of the b1 program "
            "%.1f s; waited for %.1f s here), AOTInductor compile %.1f s; "
            ".pt2 MB %s, package %.1f MB; reloaded programs bit-equal to "
            "eager at batches %s, launches by kernel name %s"
            % (label, rec["export_wall_s"], rec["export_s"], rec["waited_s"],
               rec["aoti_compile_s"], {b: round(v, 2) for b, v in
                                       rec["pt2_mb"].items()},
               rec["aoti_mb"], sorted(rec["batches"]),
               rec["batches"][1]["launches"]))
        r = rec["runner"]
        log("export %s runner (C++, no Python; package loaded in %.0f ms): "
            "%d detections >= 0.1 matched both ways with the Python "
            "program; op calls per frame %s; latency at depth 1 p50 %.3f "
            "ms, p99 %.3f ms (max %.3f); frames/s %.1f at depth 1, %.1f at "
            "depth %d%s"
            % (label, r["load_ms"], r["matched"],
               {k: v for k, v in r["op_calls_per_frame"].items() if v},
               r["latency_ms_depth1"]["p50"], r["latency_ms_depth1"]["p99"],
               r["latency_ms_depth1"]["max"], r["fps_depth1"],
               r["fps_depth"], r["depth"],
               "; serving engine bucket 1 (phase serve) p50 %.3f ms, p99 "
               "%.3f ms" % (serve["p50_ms"], serve["p99_ms"])
               if "p50_ms" in serve else ""))
        del model, predict
        torch.cuda.empty_cache()


def phase_export(state):
    """Export end to end (`export.export_predict`, the port of ref
    export.py:60) at 512^2 with the uint8 wire, for EXPORT_RUNS (seeded
    weights and BN state): the flagship bf16 with --export-serve at
    buckets 1 and 16 (one AOTInductor package, batch 1) and the
    throughput tier's int8 (one package), each exported by a worker
    process (started by phase export_compile, else here; their
    AOTInductor compiles overlap); each reloaded `.pt2`
    (`load_exported`) bit-equal to the eager predict at its batch, its
    launches counted by kernel name in a profiler trace (and by the
    launch counters) equal to `expected_launches`; then the op library
    and the C++ runner (`_build.build_ops`, built by the first worker
    after its export) and, with no Python, the
    runner on each package with a seeded uint8 image file: its
    detections matched both ways against the Python program's on that
    image (class, IoU >= 0.99, |score difference| <= 1e-3), its per-frame
    op calls equal to the derived launches, latency p50/p99 at depth 1
    and frames/s at depths 1 and RUNNER_DEPTH (the serving engine's
    bucket-1 latency of phase serve beside it); export wall, program
    sizes, compile seconds; the host microseconds of each op's call
    against the route before the ops (`op_host_us`)."""
    import numpy as np
    from real_time_helmet_detection_tpu_torch.ops import _build
    from real_time_helmet_detection_tpu_torch.utils import atomic_write_bytes
    build = os.path.join(REPO, "build")
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          os.path.join(build, "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    out = state.setdefault("export", {})
    from real_time_helmet_detection_tpu_torch.export import \
        _inductor_configs
    log("export: AOTInductor settings %s" % _inductor_configs())
    if "workers" in EXPORT_BG:
        root, workers = EXPORT_BG.pop("root"), EXPORT_BG.pop("workers")
    else:
        root, workers = start_export_workers()

    def runner():  # current builds: the first worker built them
        _build.build_ops()
        return _build.runner_path()

    images = np.random.default_rng(12).integers(
        0, 256, (16, 512, 512, 3), dtype=np.uint8)
    image_file = os.path.join(root, "image.u8")
    atomic_write_bytes(image_file, images[0].tobytes())
    try:
        export_runs(state, out, root, images, image_file, runner, workers)
    finally:
        for p in workers.values():
            if p.poll() is None:
                p.kill()
            p.wait()
            BACKGROUND.pop(p.pid, None)
    out["host_us"] = op_host_us(state)
    log("export: host us of one call (mean of two turns): public wrapper "
        "/ the op alone / the wrapper before the ops (checks, output, "
        "ctypes):")
    for name, t in out["host_us"].items():
        log("  %-13s %.1f / %.1f / %.1f" % (name, t["wrapper"], t["op"],
                                             t["old"]))
    shutil.rmtree(root, ignore_errors=True)


def scale_tree(tree, factor):
    """A copy of a scales tree with every leaf times `factor`."""
    import numpy as np
    if isinstance(tree, dict):
        return {k: scale_tree(v, factor) for k, v in tree.items()}
    return np.float32(np.float32(tree) * np.float32(factor))


def int8_eval(cfg):
    """`evaluate` of a 16-image 512^2 fixture at cfg (calibrating on its
    first batch, persisting the scales, predicting through the engine),
    against eager int8 predicts of the same weights with the saved
    scales: every image's detections equal."""
    import json as json_mod
    import pickle

    import numpy as np
    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        make_synthetic_voc
    from real_time_helmet_detection_tpu_torch.evaluate import (
        evaluate, load_eval_state)
    from real_time_helmet_detection_tpu_torch.ops.quant import load_scales
    from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
    from real_time_helmet_detection_tpu_torch.data.eval_loader import \
        eval_batches
    from real_time_helmet_detection_tpu_torch.data.voc import VOCDataset
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = make_synthetic_voc(os.path.join(tmp, "voc"), num_train=0,
                                  num_test=16, imsize=(512, 512), seed=0)
        out = os.path.join(tmp, "out")
        ecfg = dataclasses.replace(cfg, data=root, save_path=out,
                                   calib_batches=1, serve_max_wait_ms=50.0,
                                   print_interval=1000)
        m = evaluate(ecfg)
        path = os.path.join(out, "calibration", "quant_scales.json")
        require(os.path.exists(path) and math.isfinite(m["map"]),
                "int8 eval: scales %s, mAP %s" % (os.path.exists(path),
                                                  m["map"]))
        with open(path) as f:
            digest = json_mod.load(f)["sha256"]
        predict = make_predict_fn(load_eval_state(ecfg), ecfg,
                                  normalize="imagenet",
                                  quant_scales=load_scales(path))
        with open(os.path.join(out, "prediction_results.pickle"), "rb") as f:
            got = pickle.load(f)
        n_det, same = 0, True
        t = ecfg.imsize
        for batch in eval_batches(VOCDataset(root, image_set="test"), t, 16):
            b, c, s, v = (x.cpu().numpy() for x in predict(batch.image))
            for j, info in enumerate(batch.infos):
                key = os.path.splitext(info["annotation"]["filename"])[0]
                size = info["annotation"]["size"]
                ow, oh = int(size["width"]), int(size["height"])
                scale = np.array([ow / t, oh / t, ow / t, oh / t],
                                 np.float32)
                row = (b[j][v[j]] * scale, c[j][v[j]], s[j][v[j]])
                n_det += len(row[2])
                same &= all(np.array_equal(x, y) for x, y in zip(
                    (got[key]["box"], got[key]["cls"], got[key]["score"]),
                    row))
        require(same, "int8 eval through the engine: detections differ "
                "from eager int8 predicts with the saved scales")
        return dict(map=m["map"], sha256=digest, detections=n_det)


def trace_device_ms(run, reps=3, counts=None):
    """(device ms per call by kernel name, traced wall ms per call) of
    `run(i)` for i < reps (`obs.roofline.device_ms_by_name`)."""
    from real_time_helmet_detection_tpu_torch.obs import roofline
    return roofline.device_ms_by_name(run, reps, counts)


def group_device_ms(by_name, kernels):
    """Device ms by group: each of our `kernels`, convolution, the
    optimizer, copies, the rest (`obs.roofline.kernel_groups`)."""
    from real_time_helmet_detection_tpu_torch.obs import roofline
    return roofline.kernel_groups(by_name, kernels)


def log_profile(what, wall_ms, traced_ms, by_name, groups, top):
    from real_time_helmet_detection_tpu_torch.obs import roofline
    for line in roofline.profile_lines(what, wall_ms, traced_ms, by_name,
                                       groups, top):
        log(line)


def phase_train_cli(state):
    """`--train-flag` for one epoch on a 32-image 512^2 synthetic fixture
    (--amp, batch 16), then the eval CLI on the weights it wrote; beside
    the first, the fused input path and gradient accumulation through the
    CLI (the three train runs share the card)."""
    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        make_synthetic_voc
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        root = make_synthetic_voc(os.path.join(tmp, "voc"), num_train=32,
                                  num_test=16, imsize=(512, 512), seed=0)
        out = os.path.join(tmp, "w")
        train_cmd = [sys.executable, "-m",
                     "real_time_helmet_detection_tpu_torch", "--train-flag",
                     "--data", root, "--batch-size", "16", "--amp",
                     "--num-stack", "1", "--end-epoch", "1",
                     "--print-interval", "1", "--save-path", out]
        weights = os.path.join(out, "check_point_1", "weights.npz")
        eval_cmd = [sys.executable, "-m",
                    "real_time_helmet_detection_tpu_torch", "--data", root,
                    "--imsize", "512", "--batch-size", "16", "--amp",
                    "--model-load", weights, "--save-path",
                    os.path.join(out, "eval")]
        # the fused input path through the CLI
        fused_cmd = train_cmd[:-1] + [os.path.join(tmp, "w_fused"),
                                      "--device-augment", "--cache-device",
                                      "--prewarm"]
        # gradient accumulation through the CLI: one epoch of 8 host steps
        # on 128 images, 4 updates of 2 x 2 micro-batches of 8
        root128 = make_synthetic_voc(os.path.join(tmp, "voc128"),
                                     num_train=128, num_test=0,
                                     imsize=(512, 512), seed=1)
        # (one print step: the loss of each step from the checkpoint's
        # loss log, not from 8 print lines and their training-log PNGs)
        accum_cmd = [sys.executable, "-m",
                     "real_time_helmet_detection_tpu_torch", "--train-flag",
                     "--data", root128, "--batch-size", "16", "--amp",
                     "--grad-accum", "2", "--sub-divisions", "2",
                     "--end-epoch", "1", "--print-interval", "8",
                     "--profile", "--save-path", os.path.join(tmp, "w_accum")]
        t0 = time.time()
        outs = run_ranks([train_cmd, fused_cmd, accum_cmd],
                         "train CLI (0 train, 1 fused, 2 accum)", timeout=600)
        train_s = time.time() - t0
        t0 = time.time()
        # the trace summary of the accumulation run's --profile trace,
        # beside the eval (phase roofline checks it)
        summary_cmd = [sys.executable, "-m",
                       "real_time_helmet_detection_tpu_torch.obs."
                       "trace_summary", os.path.join(tmp, "w_accum",
                                                     "trace"),
                       "--top", "1000"]
        eval_out, summary_out = run_ranks(
            [eval_cmd, summary_cmd], "eval CLI and trace summary",
            timeout=600)
        eval_s = time.time() - t0

        def tail(text):
            return "\n".join(text.splitlines()[-12:])

        def short(cmd):
            return " ".join(cmd[1:]).replace(tmp, "<tmp>")
        iters = [l for l in outs[0].splitlines() if " iter " in l]
        require(len(iters) == 2 and os.path.exists(weights)
                and os.path.exists(os.path.join(
                    out, "check_point_1", "checkpoint.pt")),
                "train CLI: %d iteration lines, checkpoint %s:\n%s"
                % (len(iters), os.path.exists(weights), tail(outs[0])))
        pngs = sorted(os.listdir(os.path.join(out, "training_log")))
        require(pngs == ["e0_i%d_%s.png" % (i, k) for i in (0, 1)
                         for k in ("gt", "pred")],
                "train CLI training_log holds %s" % pngs)
        log("train_cli train: python %s (%.1f s, beside fused and accum) "
            "-> %s; training_log %s" % (short(train_cmd), train_s,
                                        iters[-1].split(", ", 1)[1],
                                        " ".join(pngs)))
        maps = [l for l in eval_out.splitlines() if ": mAP " in l]
        require(len(maps) == 1, "eval CLI printed no mAP:\n%s"
                % tail(eval_out))
        log("train_cli eval: python %s (%.1f s) -> %s" % (
            short(eval_cmd), eval_s, maps[0].split(": ", 1)[1]))
        iters = [ln for ln in outs[1].splitlines() if " iter " in ln]
        require(len(iters) == 2 and "prewarmed bucket 512" in outs[1]
                and os.path.exists(os.path.join(tmp, "w_fused",
                                                "check_point_1",
                                                "weights.npz")),
                "train CLI --device-augment --cache-device --prewarm: %d "
                "iteration lines:\n%s" % (len(iters), tail(outs[1])))
        log("train_cli fused: python %s (beside train) -> %s" % (
            short(fused_cmd), iters[-1].split(", ", 1)[1]))
        import torch
        totals = [float(v) for v in torch.load(
            os.path.join(tmp, "w_accum", "check_point_1", "checkpoint.pt"),
            map_location="cpu", weights_only=False)["loss_log"]["total"]]
        require(len(totals) == 8 and sum(totals[-2:]) < sum(totals[:2]),
                "train CLI --grad-accum 2 --sub-divisions 2: the loss does "
                "not fall over 8 steps: %s\n%s" % (totals, tail(outs[2])))
        state["train_cli_accum"] = dict(totals=totals, seconds=train_s)
        log("train_cli accum: python %s (beside train): 8 steps, 4 updates, "
            "total loss per step %s" % (
                short(accum_cmd), " ".join("%.2f" % v for v in totals)))
        state["train_cli_profile"] = profile_trace_checked(
            os.path.join(tmp, "w_accum", "trace"), outs[2])
        state["train_cli_trace_summary"] = trace_summary_read(summary_out)
        state["train_cli_summary"] = summary_checked(outs)


# the train kernels #4-#13 by their names in a trace (#5 is #2's vector
# kernel, #10/#11 the residual instances of #6/#7's templates)
TRAIN_TRACE_KERNELS = ("bn_stats_kernel", "bn_act_vec_kernel",
                       "bn_bwd_sums_kernel", "bn_bwd_dx_kernel",
                       "bn_add_act_kernel", "loss_fwd_kernel", "loss_bwd")


def trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def profile_trace_checked(trace_dir, out):
    """`--profile`'s trace of the accumulation run: written whole into
    `<save>/trace`, its path printed, the train kernels #4-#13 in it and
    exactly the ProfilerStep markers of steps 2-7."""
    path = os.path.join(trace_dir, "trace.json")
    require(os.path.isfile(path) and "profiler trace -> " + trace_dir in out,
            "--profile: no trace at %s (or its path not printed)" % path)
    events = trace_events(path)
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    missing = [k for k in TRAIN_TRACE_KERNELS
               if not any(k in name for name in kernels)]
    steps = sorted({int(e["name"].split("#", 1)[1]) for e in events
                    if e.get("name", "").startswith("ProfilerStep#")})
    require(not missing and steps == list(range(2, 8)),
            "--profile trace: train kernels missing %s, ProfilerStep "
            "markers %s (want 2-7)" % (missing, steps))
    n = sum(e.get("cat") == "kernel" for e in events)
    log("train_cli profile: %s, %d kernel records, steps %s, %.1f MB"
        % (path.replace(os.path.dirname(os.path.dirname(trace_dir)), "<tmp>"),
           n, steps, os.path.getsize(path) / 1e6))
    return dict(kernel_records=n, steps=steps,
                mb=os.path.getsize(path) / 1e6)


def trace_summary_read(text):
    """{track: (summed ms, wall ms)} and {track: [names]} of
    `obs.trace_summary`'s output."""
    tracks, names, track = {}, {}, None
    for line in text.splitlines():
        head = re.match(r"== (.*)  \(sum ([0-9.]+) ms over wall ([0-9.]+) "
                        r"ms, ", line)
        row = re.match(r"\s+[0-9.]+ ms\s+[0-9.]+%  (.*)$", line)
        if head:
            track = head.group(1)
            tracks[track] = (float(head.group(2)), float(head.group(3)))
            names[track] = []
        elif row and track is not None:
            names[track].append(row.group(1))
    return dict(tracks=tracks, names=names)


def device_records(prof):
    """{"kernel": n, "gpu_memcpy": n, "gpu_memset": n} of a finished
    torch.profiler run, and its memcpy records by kind with their bytes
    ({"HtoD": [n, bytes], "DtoH": [n, bytes]})."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = trace_events(path)
    cats = {c: 0 for c in ("kernel", "gpu_memcpy", "gpu_memset")}
    copies = {"HtoD": [0, 0], "DtoH": [0, 0]}
    names = {}
    for e in events:
        if e.get("cat") == "gpu_memcpy":
            names[e.get("name")] = names.get(e.get("name"), 0) + 1
        if e.get("cat") in cats:
            cats[e["cat"]] += 1
        for kind, rec in copies.items():
            if e.get("cat") == "gpu_memcpy" \
                    and e.get("name", "").startswith("Memcpy " + kind):
                rec[0] += 1
                rec[1] += int(e.get("args", {}).get("bytes", 0))
    copies["names"] = names
    return cats, copies


def profiled(run):
    """(run's result, device_records) of the second of two calls of run()
    under torch.profiler, CPU and CUDA activity: the first is the
    schedule's warm-up step, traced and dropped, so that the recorded
    step starts on a running tracer (a copy issued right at a trace's
    start can go unrecorded); each step synchronized before it ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            out = run()
            torch.cuda.synchronize()
            prof.step()
    return out, device_records(prof)


def summary_checked(outs):
    """The layer table (`--summary`, on by default) of every train CLI run
    totals the flagship's parameters; `layer_summary` called under the
    profiler with the train model on the card launches no kernel and
    copies nothing."""
    import torch
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.models.hourglass import (
        build_model, layer_summary)
    cfg = Config(batch_size=16, amp=True)
    model = build_model(cfg, dtype=torch.bfloat16).cuda()
    count = sum(p.numel() for p in model.parameters())
    totals = [[int(ln.split(":")[1]) for ln in out.splitlines()
               if ln.startswith("total params: ")] for out in outs]
    require(all(t == [count] for t in totals),
            "train CLI layer tables total %s, the model %d" % (totals, count))
    (rows, total), (cats, _) = profiled(lambda: layer_summary(cfg, 512))
    require(total == count and sum(cats.values()) == 0,
            "layer_summary on the card's model: total %d (model %d), "
            "device records %s" % (total, count, cats))
    del model
    log("train_cli summary: %d rows, total %d params in each of %d runs; "
        "layer_summary under the profiler: %s device records"
        % (len(rows), total, len(outs), cats))
    return dict(rows=len(rows), total=total, device_records=cats)


# ------------------------------------------------------ the supervisor phase

SUPERVISOR_HEARTBEAT_S = 30.0  # the train job's stale-kill deadline
TRANSIENT_JOB = (
    "import os\n"
    "from real_time_helmet_detection_tpu_torch.runtime.errors import "
    "InjectedBackendError\n"
    "from real_time_helmet_detection_tpu_torch.runtime.heartbeat import "
    "run_as_job\n"
    "from real_time_helmet_detection_tpu_torch.utils import "
    "atomic_write_bytes\n"
    "def main():\n"
    "    marker = os.environ['SMOKE_MARKER']\n"
    "    if not os.path.exists(marker):\n"
    "        atomic_write_bytes(marker, b'1')\n"
    "        raise InjectedBackendError('UNAVAILABLE: injected on the "
    "first attempt')\n"
    "run_as_job(main)\n"
)


# the activation-sized tensors each BN kernel's call moves: the byte rule
# the roofline's rows must meet at every site (ref epilogue.py:84,
# residual.py:78 `site_kernel_bytes`, split over the port's passes)
SITE_MOVES = {"bn_act": 2, "bn_add_act": 3, "bn_stats": 1, "bn_bwd_sums": 2,
              "bn_add_bwd_sums": 3, "bn_bwd_dx": 3, "bn_add_bwd_dx": 5}
# phase roofline's runs: (label, roofline CLI flags, expected_launches path)
ROOFLINE_RUNS = (("predict bf16", ["--mode", "predict"], "predict"),
                 ("train --amp", [], "train"),
                 ("train --amp --fwd-dtype int8", ["--fwd-dtype", "int8"],
                  "train"))
IMPOSSIBLE = 1.05  # a share of a roofline above this: the count is wrong


def roofline_checked(label, argv, path):
    """One roofline of the card (`obs.roofline.roofline`, the CLI's
    function) at b16 512^2, checked: every device operation joined (at
    most 1% of busy unattributed; the rows' times add up to busy within
    0.5%), each hand kernel's calls as `expected_launches` derives and
    its bytes `SITE_MOVES`' rule at its sites, no row outside the L2
    above IMPOSSIBLE of its roofline. Returns the artifact."""
    import torch
    from real_time_helmet_detection_tpu_torch.obs import roofline
    args = roofline.build_parser().parse_args(argv)
    meta = roofline.roofline(args)
    rows, s = meta["fusions"], meta["summary"]
    busy, un = s["busy_us"], s["unattributed_us"]
    timed = sum(r["time_us"] or 0.0 for r in rows)
    require(un <= 0.01 * busy and abs(timed - busy) <= 0.005 * busy,
            "roofline %s: %.1f us of %.1f us busy unattributed, rows sum "
            "to %.1f us" % (label, un, busy, timed))
    cfg = roofline._config(args, train=path == "train")
    want = {k: v for k, v in expected_launches(cfg, path,
                                               torch.bfloat16).items()
            if v and k in roofline.KERNELS}
    kernels = {r["name"]: r for r in rows if r.get("kernel")}
    require({k: r["calls"] for k, r in kernels.items()} == want,
            "roofline %s: kernel calls %s, want %s" % (
                label, {k: r["calls"] for k, r in kernels.items()}, want))
    # every call launches: fewer device operations than calls means the
    # trace lost some of the card's activity
    short = {k: (r.get("trace_calls"), r["calls"])
             for k, r in kernels.items()
             if (r.get("trace_calls") or 0) < r["calls"]}
    require(not short, "roofline %s: the trace holds fewer device "
            "operations than calls (per run): %s" % (label, short))
    for name, r in kernels.items():
        if name in SITE_MOVES:
            rule = sum(SITE_MOVES[n] * e * size
                       for n, e, size, _ in meta["kernel_sites"]
                       if n == name)
            require(r["bytes"] == rule, "roofline %s: %s moves %.0f "
                    "bytes, its rule %.0f" % (label, name, r["bytes"], rule))
    over = [(r["name"], r["t_roofline_us"], r["time_us"]) for r in rows
            if r["time_us"] and not r["l2_resident_possible"]
            and r["t_roofline_us"] > IMPOSSIBLE * r["time_us"]]
    require(not over, "roofline %s: rows read above %.0f%% of their "
            "roofline: %s; hand kernels (device ops, calls): %s" % (
                label, 100 * IMPOSSIBLE, over[:5],
                {k: (r.get("trace_calls"), r["calls"])
                 for k, r in kernels.items()}))
    log("roofline %s: busy %.1f us, wall %.1f us (untraced; traced %.1f), "
        "idle %.1f%%, mfu %.4f, %.3f TFLOP, %.2f GB, %d rows, unattributed "
        "%.1f us; seconds %s" % (label, busy, s["wall_us"],
                                 s["traced_wall_us"], 100 * s["idle_share"],
                                 s["mfu"], s["total_flops"] / 1e12,
                                 s["total_bytes"] / 1e9, len(rows), un,
                                 meta["seconds"]))
    log("    %-64s %5s %9s %6s %9s %6s %5s %s" % (
        "row (top 10 by time)", "calls", "us/step", "%time", "MB", "roofl",
        "bound", "L2"))
    for r in rows[:10]:
        log("    %-64s %5d %9.1f %6.1f %9.1f %5.0f%% %5s %s" % (
            r["name"][:64], r["calls"], r["time_us"] or 0.0,
            r["pct_time"] or 0.0, r["bytes"] / 2**20,
            100 * r["t_roofline_us"] / r["time_us"] if r["time_us"] else 0,
            r["bound"], "yes" if r["l2_resident_possible"] else "no"))
    log("    class: %s" % ", ".join(
        "%s %.1f us (hand kernels %.1f; %d calls, %.1f%% of bytes, %d "
        "rows)" % (c, v["time_us"], v["kernel_time_us"], v["calls"],
                   v["pct_bytes"], v["ops"])
        for c, v in s["by_class"].items()))
    log("    hand kernels: %s" % ", ".join(
        "#%s %s %d calls %.1f us (%.0f%% of roofline)" % (
            r["kernel"], n, r["calls"], r["time_us"] or 0.0,
            100 * r["t_roofline_us"] / r["time_us"] if r["time_us"] else 0)
        for n, r in sorted(kernels.items(),
                           key=lambda kv: kv[1]["kernel"])))
    return meta


def phase_roofline(state):
    """Where the card's time goes, through `obs.roofline`,
    `obs.breakdown` and `obs.trace_summary`: the roofline of the
    flagship bf16 predict, the flagship `--amp` train step and its
    `--fwd-dtype int8` step at b16 512^2 (`roofline_checked`), the conv
    FLOPs of the predict equal to `quality/cost.py`'s at the same
    configuration, the breakdown's components (each `mfu` and HBM
    utilisation at most IMPOSSIBLE), and the trace summary of train_cli's
    `--profile` trace (run there): the train kernels #4-#13 among its
    kernels, every kernel stream's busy share in (0, 1]."""
    import torch
    from real_time_helmet_detection_tpu_torch.obs import breakdown, roofline
    from real_time_helmet_detection_tpu_torch.quality import cost
    require("train_cli_trace_summary" in state,
            "phase roofline reads the trace summary of train_cli's "
            "--profile trace: run train_cli too")
    out = state.setdefault("roofline", {})
    for label, argv, path in ROOFLINE_RUNS:
        t0 = time.time()
        meta = roofline_checked(label, argv, path)
        out[label] = meta["summary"]
        log("    (%.1f s)" % (time.time() - t0))
        if path == "predict":
            args = roofline.build_parser().parse_args(argv)
            cfg = roofline._config(args, train=False)
            conv = sum(r["flops"] for r in meta["fusions"]
                       if r["opcode"] == "convolution")
            want = args.batch * cost.counts(cfg, args.imsize)["conv_flops"]
            require(conv == want, "roofline predict: conv FLOPs %.0f, "
                    "quality/cost.py's %.0f" % (conv, want))
        torch.cuda.empty_cache()
    t0 = time.time()
    last = [t0]

    def timed_log(msg):
        now = time.time()
        log("    %s (%.1f s)" % (msg, now - last[0]))
        last[0] = now
    bd = breakdown.breakdown("cuda", log=timed_log)
    out["breakdown"] = bd["components"]
    over = {k: (c["mfu"], c["hbm_util"]) for k, c in bd["components"].items()
            if max(c["mfu"], c["hbm_util"]) > IMPOSSIBLE}
    require(not over, "breakdown: components above %.0f%% of a peak: %s"
            % (100 * IMPOSSIBLE, over))
    log("    breakdown: %d components (%.1f s)" % (len(bd["components"]),
                                                   time.time() - t0))
    ts = state["train_cli_trace_summary"]
    kernel_tracks = {t: n for t, n in ts["names"].items()
                     if any(k in name for name in n
                            for k in TRAIN_TRACE_KERNELS)}
    named = {k for k in TRAIN_TRACE_KERNELS
             for n in kernel_tracks.values() for name in n if k in name}
    shares = {t: ts["tracks"][t][0] / ts["tracks"][t][1]
              for t in kernel_tracks}
    require(named == set(TRAIN_TRACE_KERNELS)
            and all(0 < v <= 1 for v in shares.values()),
            "trace summary: train kernels named %s of %s, busy shares %s"
            % (sorted(named), TRAIN_TRACE_KERNELS, shares))
    log("    trace summary of train_cli's --profile trace (beside its "
        "eval CLI): %s; the train kernels #4-#13 named" % ", ".join(
            "%s busy %.1f%%" % (t, 100 * v) for t, v in shares.items()))


def group_members(pgid):
    """(pid, state) of every process whose process group is `pgid`."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % pid) as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[2]) == pgid:
            out.append((int(pid), fields[0]))
    return out


def stop_after_checkpoint(spool, job, ckpt, stopped, quit_evt):
    """The watcher thread of phase supervisor: once `job`'s first attempt
    runs and `ckpt` is complete, SIGSTOP its process group — a hang that
    stops every beat — once."""
    import signal
    while not quit_evt.wait(0.05):
        js = spool.jobs.get(job)
        if js is None or js.attempt != 1 or js.state != "running" \
                or not js.pid:
            continue
        if all(os.path.exists(os.path.join(ckpt, f))
               for f in ("checkpoint.pt", "weights.npz")):
            os.killpg(js.pid, signal.SIGSTOP)
            stopped.update(pid=js.pid, t=time.time())
            return


def phase_supervisor(state):
    """The job supervisor with its default probes over real subprocess
    jobs on a 32-image 512^2 synthetic VOC, the flagship `--amp` at b16:
    the triage (one waiter, #1 launched and bit-equal to its plain
    version); job `train` (2 epochs of 2 steps, a checkpoint each, print
    interval 2), hung on its first attempt by a SIGSTOP of its process
    group after its first checkpoint: stale-killed, salvaged with its
    `check_point_*`, requeued and resumed from its save dir on attempt
    2 to its last step; job `eval` of that save dir, whose txt files
    score to its own mAP; a `run_as_job` job failing transiently once;
    a bad flag failing permanently; traceview over the jobs' span log;
    the queue metrics. Walls: each attempt, the kill latency, the
    respawn to the first step, the triage."""
    import threading
    import xml.etree.ElementTree as ET
    import torch
    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        make_synthetic_voc
    from real_time_helmet_detection_tpu_torch.data.voc import (
        boxes_from_voc_dict, parse_voc_xml)
    from real_time_helmet_detection_tpu_torch.metrics import (
        compute_map, compute_map_from_txt)
    from real_time_helmet_detection_tpu_torch.obs import traceview
    from real_time_helmet_detection_tpu_torch.obs.metrics import (
        read_latest, reset_default_registry, snapshot_digest)
    from real_time_helmet_detection_tpu_torch.runtime import (
        HEALTHY, JobSpec, Spool, Supervisor)
    from real_time_helmet_detection_tpu_torch.utils import load_pickle
    pkg = "real_time_helmet_detection_tpu_torch"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_queue_") as tmp:
        root = make_synthetic_voc(os.path.join(tmp, "voc"), num_train=32,
                                  num_test=16, imsize=(512, 512), seed=2)
        save = os.path.join(tmp, "w")
        env = {"PYTHONPATH": REPO}
        base = shlex.join([sys.executable, "-m", pkg, "--train-flag",
                           "--data", root, "--batch-size", "16", "--amp",
                           "--num-stack", "1", "--end-epoch", "2",
                           "--print-interval", "2", "--save-path", save])
        # one command for both attempts: a fresh start, or the resume
        # from the save dir's newest complete checkpoint once it has one
        train_sh = ("if ls %s/check_point_*/weights.npz >/dev/null 2>&1; "
                    "then exec %s --model-load %s; else exec %s; fi"
                    % (shlex.quote(save), base, shlex.quote(save), base))
        metrics_path = os.path.join(tmp, "obs", "metrics.jsonl")
        saved_env = {k: os.environ.get(k)
                     for k in ("OBS_METRICS", "OBS_SPAN_LOG")}
        os.environ["OBS_METRICS"] = metrics_path
        os.environ.pop("OBS_SPAN_LOG", None)
        reset_default_registry()
        lines = []

        def sup_log(msg):
            lines.append((time.time(), msg))
            log("  [queue] %s" % msg)

        spool = Spool(os.path.join(tmp, "queue"))
        stopped, quit_evt = {}, threading.Event()
        watcher = threading.Thread(
            target=stop_after_checkpoint, name="smoke-hang", args=(
                spool, "train", os.path.join(save, "check_point_1"),
                stopped, quit_evt))
        try:
            for spec in (
                    JobSpec(job="train", argv=["/bin/sh", "-c", train_sh],
                            artifacts=["w/check_point_*"], cwd=tmp,
                            heartbeat_timeout_s=SUPERVISOR_HEARTBEAT_S,
                            # no backoff: FIFO then takes its attempt 2
                            # before the eval of its save dir
                            max_attempts=2, backoff_base_s=0.0,
                            backoff_cap_s=0.0, env=env),
                    JobSpec(job="eval", argv=[
                        sys.executable, "-m", pkg, "--data", root,
                        "--imsize", "512", "--batch-size", "16", "--amp",
                        "--model-load", save, "--save-path",
                        os.path.join(save, "eval")], cwd=tmp,
                        heartbeat_timeout_s=300.0, max_attempts=1, env=env),
                    JobSpec(job="transient", argv=[
                        sys.executable, "-c", TRANSIENT_JOB], cwd=tmp,
                        heartbeat_timeout_s=60.0, max_attempts=2,
                        backoff_base_s=1.0, backoff_cap_s=2.0,
                        env=dict(env, SMOKE_MARKER=os.path.join(
                            tmp, "transient_marker"))),
                    JobSpec(job="permanent", argv=[
                        sys.executable, "-m", pkg, "--no-such-flag"],
                        cwd=tmp, heartbeat_timeout_s=60.0, max_attempts=3,
                        env=env)):
                spool.enqueue(spec)
            sup = Supervisor(spool, kill_grace_s=2.0, poll_s=0.2,
                             log=sup_log)
            t0 = time.time()
            verdict = sup.triage()
            triage_s = time.time() - t0
            require(verdict == HEALTHY and sup.waiters_spawned == 1,
                    "triage %s with %d waiters" % (verdict,
                                                   sup.waiters_spawned))
            watcher.start()
            summary = sup.run()
        finally:
            quit_evt.set()
            if watcher.is_alive():
                watcher.join()
            spool.close()
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        with open(sup.waiter_log_path()) as f:
            waiter_log = f.read()
        clear = [l for l in waiter_log.splitlines()
                 if l.startswith("device clear:")]
        require(len(clear) == sup.waiters_spawned == 3
                and "waiter:" not in waiter_log
                and all("launched 1 kernel(s), bit-equal" in l
                        for l in clear),
                "each triage one waiter, #1 bit-equal: %d waiters, log:\n%s"
                % (sup.waiters_spawned, waiter_log))
        waiter_launches = int(clear[0].split(" launched ")[1].split()[0])
        with open(spool.path) as f:
            recs = [json.loads(l) for l in f if l.strip()]

        def states(job):
            return [r for r in recs if r.get("kind") == "state"
                    and r["job"] == job]
        seq = [r["state"] for r in states("train")]
        require(seq == ["queued", "running", "salvaged", "queued",
                        "running", "done"] and stopped,
                "job train went %s (stopped %s)" % (seq, stopped))
        salvaged = [a["path"] for a in states("train")[2][
            "salvaged_artifacts"]]
        require(salvaged == ["w/check_point_1"],
                "job train salvaged %s" % salvaged)
        pgid = stopped["pid"]
        reap_zombies()  # the group's orphans were adopted by this process
        require(not group_members(pgid), "attempt 1's process group %d "
                "survives: %s" % (pgid, group_members(pgid)))
        with open(spool.log_path("train", 2)) as f:
            log2 = f.read()
        ckpt = torch.load(os.path.join(save, "check_point_2",
                                       "checkpoint.pt"),
                          map_location="cpu", weights_only=False)
        require("resumed from" in log2 and int(ckpt["step"]) == 4
                and int(ckpt["epoch"]) == 1,
                "attempt 2: resumed %s, last checkpoint step %s epoch %s"
                % ("resumed from" in log2, ckpt["step"], ckpt["epoch"]))
        pngs = sorted(os.listdir(os.path.join(save, "training_log")))
        want_pngs = ["e%d_i0_%s.png" % (e, k) for e in range(2)
                     for k in ("gt", "pred")]
        require(set(want_pngs) <= set(pngs), "training_log holds %s" % pngs)
        # eval: its txt files against its own detections
        eval_dir = os.path.join(save, "eval")
        seq_e = [r["state"] for r in states("eval")]
        require(seq_e == ["queued", "running", "done"],
                "job eval went %s" % seq_e)
        with open(os.path.join(root, "ImageSets", "Main", "test.txt")) as f:
            ids = [l.strip() for l in f if l.strip()]
        gt_b, gt_l = {}, {}
        for i in ids:
            gt_b[i], gt_l[i] = boxes_from_voc_dict(parse_voc_xml(ET.parse(
                os.path.join(root, "Annotations", i + ".xml")).getroot()))
        dets = load_pickle(os.path.join(eval_dir,
                                        "prediction_results.pickle"))
        own = compute_map(gt_b, gt_l, {k: v["box"] for k, v in dets.items()},
                          {k: v["cls"] for k, v in dets.items()},
                          {k: v["score"] for k, v in dets.items()})["map"]
        from_txt = compute_map_from_txt(os.path.join(
            eval_dir, "results", "txt"), gt_b, gt_l)["map"]
        with open(spool.log_path("eval", 1)) as f:
            shown = [l.split(": mAP ")[1].split()[0] for l in f
                     if ": mAP " in l]
        require(len(shown) == 1 and abs(own - float(shown[0])) <= 5e-5
                and abs(own - from_txt) <= 1e-9,
                "eval mAP printed %s, own %.12f, from its txt files %.12f"
                % (shown, own, from_txt))
        seq_t = [r["state"] for r in states("transient")]
        status = [json.load(open(spool.status_path("transient", a)))
                  for a in (1, 2)]
        require(seq_t == ["queued", "running", "salvaged", "queued",
                          "running", "done"]
                and status[0].get("error_class") == "transient"
                and not status[0]["ok"] and status[1]["ok"],
                "job transient went %s, status files %s" % (seq_t, status))
        seq_p = [r["state"] for r in states("permanent")]
        require(seq_p == ["queued", "running", "failed"]
                and states("permanent")[-1].get("error_class")
                == "permanent", "job permanent went %s" % seq_p)
        require(summary["jobs"] == {
            "train": {"state": "done", "attempt": 2},
            "eval": {"state": "done", "attempt": 1},
            "transient": {"state": "done", "attempt": 2},
            "permanent": {"state": "failed", "attempt": 1}},
            "summary %s" % summary)
        # traceview over the jobs' span log
        span_log = os.path.join(tmp, "obs", "spans.jsonl")
        traces = traceview.assemble_logs([span_log])
        report = traceview.analyze(traces)
        require(report["request_traces"] > 0 and report["orphans"] == 0
                and report["broken_chains"] == 0 and report["step_traces"]
                > 0, "traceview: %s" % report)
        slowest = traceview.tail_exemplars(traces, 1)[0]
        # the queue metrics
        snap = read_latest(metrics_path)
        counters = snap["counters"]
        require(counters.get("queue.requeues", 0) >= 2
                and counters.get("queue.salvages", 0) >= 2,
                "queue counters %s" % counters)
        digest = snapshot_digest(snap)
        # walls from the journal, the supervisor's log and the span log
        runs = [r for r in states("train") if r["state"] == "running"]
        ends = [r for r in states("train")
                if r["state"] in ("salvaged", "done")]
        walls = [e["t"] - r["started_at"] for r, e in zip(runs, ends)]
        stale_t = [t for t, m in lines if "train heartbeat stale" in m][0]
        kill_s = states("train")[2]["t"] - stale_t
        steps2 = [r["t"] for r in (json.loads(l) for l in open(span_log)
                                   if l.strip())
                  if r.get("name") == "step" and r.get("pid") == runs[1]["pid"]]
        respawn_s = min(steps2) - runs[1]["started_at"]
        keep_round_files(state, {span_log: "obs/supervisor_spans.jsonl",
                                 metrics_path: "obs/metrics_supervisor.jsonl",
                                 spool.path: "queue/jobs.jsonl"})
    state["supervisor"] = dict(triage_s=triage_s, walls=walls,
                               waiter_launches=waiter_launches,
                               kill_s=kill_s, respawn_s=respawn_s,
                               stale_after_stop_s=stale_t - stopped["t"],
                               own_map=own, report=report)
    log("supervisor triage: %s in %.2f s, one waiter a triage (%d, each "
        "'%s')" % (verdict, triage_s, sup.waiters_spawned,
                   clear[0].split("; ", 1)[1]))
    log("supervisor train: journal %s; salvaged %s; attempt walls %s s; "
        "stopped at %.2f s into attempt 1, stale after %.2f s more "
        "(deadline %.0f s); kill latency (stale -> group gone) %.3f s; "
        "respawn -> first step %.2f s; attempt 2 resumed to step %d; "
        "training_log %d PNGs" % (
            " -> ".join(seq), salvaged, ", ".join("%.2f" % w for w in walls),
            stopped["t"] - runs[0]["started_at"], stale_t - stopped["t"],
            SUPERVISOR_HEARTBEAT_S, kill_s, respawn_s, int(ckpt["step"]),
            len(pngs)))
    log("supervisor eval: mAP %s printed, %.12f from its %d detections, "
        "%.12f from its txt files; transient: %s, status %s then %s; "
        "permanent: %s" % (shown[0], own, sum(len(v["score"]) for v in
                                              dets.values()),
                           from_txt, " -> ".join(seq_t),
                           status[0].get("error_class"),
                           "ok" if status[1]["ok"] else "failed",
                           " -> ".join(seq_p)))
    log("supervisor traceview: %d traces, %d request traces (%d closed), "
        "%d orphans, %d broken chains, %d step traces; slowest %s: %s" % (
            report["traces"], report["request_traces"], report["closed"],
            report["orphans"], report["broken_chains"],
            report["step_traces"], slowest["trace"],
            json.dumps(slowest["critical_path"], sort_keys=True)))
    log("supervisor metrics: %s" % json.dumps(
        {k: {n: v for n, v in d.items() if n.startswith("queue.")}
         for k, d in digest.items()}, sort_keys=True))


# ----------------------------------------------- the training runtime phase

RUNTIME_IMAGES = 160  # the input-path fixture: 10 steps of b16 an epoch


def runtime_cfg(root, save, **kw):
    """The flagship --amp train config of phase train_runtime on `root`."""
    from real_time_helmet_detection_tpu_torch.config import Config
    base = dict(train_flag=True, data=root, batch_size=16, amp=True,
                num_stack=1, print_interval=1000, save_path=save,
                hang_warn_seconds=0.0, num_workers=8)
    base.update(kw)
    return Config(**base)


class PoisonAugmentor:
    """TestAugmentor(512) whose batch 1 carries NaN float canvases (the
    per-batch reseed names the batch), for the process loader's
    quarantine; module level so that its spawned workers can load it."""

    def __init__(self, size):
        from real_time_helmet_detection_tpu_torch.data.augment import \
            TestAugmentor
        self.inner = TestAugmentor(size)
        self.imsize = size
        self.rng = None

    def __call__(self, images, boxes, labels):
        import numpy as np
        images, boxes, labels = self.inner(images, boxes, labels)
        ent = self.rng.bit_generator.seed_seq.entropy if self.rng else ()
        if tuple(ent)[2:3] == (1,):
            images = [np.full(im.shape, np.nan, np.float32) for im in images]
        return images, boxes, labels


def runtime_trainer(cfg, dev="cuda"):
    """(model, optimizer, ema, step, Trainer) of cfg, seeded weights."""
    from real_time_helmet_detection_tpu_torch.ops.loss import LossLog
    from real_time_helmet_detection_tpu_torch.train import Trainer
    model, opt, ema, step = extras_trainer(cfg)
    return model, opt, ema, step, Trainer(model, opt, ema, None, LossLog(),
                                          0, dev)


def state_equal(a, b):
    """Are two Trainer snapshots bit-identical?"""
    import torch
    for part in ("model",):
        if any(not torch.equal(a[part][k], b[part][k]) for k in a[part]):
            return False
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    return all(torch.equal(sa[k][n], sb[k][n]) for k in sa for n in sa[k])


def epoch_rate(cfg, loader, runner, epoch):
    """One epoch of `train_epoch` through `runner`: (images/s, mean data
    wait per step in ms, steps), the wall closed by a synchronize."""
    import torch
    from real_time_helmet_detection_tpu_torch.obs.metrics import \
        default_registry
    from real_time_helmet_detection_tpu_torch.ops.loss import LossLog
    from real_time_helmet_detection_tpu_torch.train import train_epoch
    wait = default_registry().histogram("train.loader_wait_ms")
    w0 = wait.snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_epoch(cfg, epoch, loader, None, torch.device("cuda"), LossLog(),
                0, chief=False, runner=runner,
                epoch_base_step=epoch * len(loader))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    w1 = wait.snapshot()
    steps = w1["count"] - w0["count"]
    return (cfg.batch_size * steps / secs,
            (w1["total"] - w0["total"]) / max(1, steps), steps)


def staged_bytes(arrays):
    return sum(t.numel() * t.element_size() for t in arrays)


def runtime_augment_check(cfg, cache):
    """One b16 batch through `augment_encode_batch` on the card and on the
    CPU with the same parameters: the images by the warp's rule (equal
    where both floors agree), boxes and validity identical, the maps
    within their tolerance."""
    import torch
    from real_time_helmet_detection_tpu_torch.data import augment_device as ad
    idx = torch.arange(16, device="cuda")
    raw = [t.index_select(0, idx) for t in (cache.images, cache.boxes,
                                            cache.labels, cache.valid)]
    params = ad.sample_params(ad.step_generator(cfg.random_seed + 2, 0), 16)
    got = ad.augment_encode_batch(params, *raw, target=512)
    torch.cuda.synchronize()
    want = ad.augment_encode_batch(params, *[t.cpu() for t in raw],
                                   target=512)
    got = [t.cpu() for t in got]
    require(torch.equal(got[5], want[5]) and torch.equal(got[6], want[6]),
            "device augment: boxes or validity differ from the CPU's")
    img_err = float((got[0] - want[0]).abs().max())
    errs = {"image": img_err}
    for i, name in ((1, "heat"), (2, "offset"), (3, "size")):
        errs[name] = float((got[i] - want[i]).abs().max())
    mask_equal = torch.equal(got[4], want[4])
    require(img_err <= 1.0 and errs["heat"] <= 1e-6
            and errs["offset"] <= 1e-6 and errs["size"] <= 1e-6
            and mask_equal,
            "device augment card vs CPU beyond tolerance: %s, mask equal %s"
            % (errs, mask_equal))
    log("train_runtime augment: b16 512^2 card vs CPU on one draw: boxes "
        "and validity identical, mask identical, max abs image %.3g (rule: "
        "equal where the floors agree, <= 1 grey level), heat %.3g, offset "
        "%.3g, size %.3g (tol 1e-6); %d valid boxes" % (
            img_err, errs["heat"], errs["offset"], errs["size"],
            int(got[6].sum())))
    return errs


def phase_train_runtime(state):
    """The training runtime at the flagship's width (residual, 1 stack,
    128 ch), b16 512^2 --amp, max_boxes 128, on a seeded 512^2 synthetic
    fixture: the device augmentation and encoder against the CPU; the
    --device-augment and --cache-device steps' launches, an f32
    device-augmented step against the plain kernels (train_main's rule)
    and 20 steps whose loss falls; images/s and data wait per step of
    five input paths; async against sync checkpoints and the boundary
    stall; retention; auto-resume against a clean run; --async-eval; the
    prewarm; telemetry norms and host syncs; the process loader's
    quarantine; the span log's names."""
    import dataclasses
    import pickle
    import statistics
    import numpy as np
    import torch
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.data.augment import \
        TestAugmentor
    from real_time_helmet_detection_tpu_torch.data.pipeline import (
        BatchLoader, DeviceDatasetCache, load_dataset)
    from real_time_helmet_detection_tpu_torch.data.shm_pool import \
        ProcessBatchLoader
    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        make_synthetic_voc
    from real_time_helmet_detection_tpu_torch.data.voc import VOCDataset
    from real_time_helmet_detection_tpu_torch.obs.spans import read_spans
    from real_time_helmet_detection_tpu_torch.obs.telemetry import \
        NORM_KEYS
    from real_time_helmet_detection_tpu_torch.train import (
        AsyncEvaluator, CheckpointWriter, load_checkpoint, make_step_runner,
        pick_target, stage, stage_raw, train)
    out = state.setdefault("train_runtime", {})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_runtime_")
    try:
        t0 = time.time()
        root = make_synthetic_voc(os.path.join(tmp, "voc"),
                                  num_train=RUNTIME_IMAGES, num_test=16,
                                  imsize=(512, 512), seed=0)
        log("train_runtime: fixture of %d + 16 images at 512^2 in %.1f s"
            % (RUNTIME_IMAGES, time.time() - t0))
        dataset = VOCDataset(root)
        cfg = runtime_cfg(root, tmp, device_augment=True, cache_device=True)
        cache = DeviceDatasetCache(dataset, TestAugmentor(512), 16,
                                   max_boxes=128, seed=cfg.random_seed,
                                   device="cuda")
        out["augment_errs"] = runtime_augment_check(cfg, cache)

        # the fused steps: launches, the f32 step against the plain
        # kernels, the loss over 20 steps
        model, opt, ema, step, trainer = runtime_trainer(cfg)
        want = expected_launches(Config(batch_size=16, imsize=512,
                                        amp=True), "train", torch.bfloat16)
        fused = make_step_runner(dataclasses.replace(cfg, cache_device=False),
                                 step, torch.device("cuda"))
        cached = make_step_runner(cfg, step, torch.device("cuda"),
                                  cache=cache)
        host_batch = next(iter(BatchLoader(
            dataset, TestAugmentor(512), 16, max_boxes=128, raw=True,
            num_workers=8)))
        idx = next(iter(cache))
        for runner, batch in ((fused, host_batch), (cached, idx)):
            runner(batch, 0, 0, True)  # warm-up
        saved = trainer.snapshot()
        launches = {}
        for name, runner, batch in (("device_augment", fused, host_batch),
                                    ("cache_device", cached, idx)):
            reset_counts()
            runner(batch, 1, 1, True)  # THE path run the counts read
            torch.cuda.synchronize()
            launches[name] = read_counts()
            require(launches[name] == want, "launches per %s step %s, want "
                    "%s" % (name, launches[name], want))
        state.setdefault("launches", {}).update(
            {"train_" + k: v for k, v in launches.items()})
        trainer.restore_snapshot(saved)
        from real_time_helmet_detection_tpu_torch.data import \
            augment_device as ad
        params = ad.sample_params(ad.step_generator(cfg.random_seed + 2, 3),
                                  16)
        mean, std = ad.normalizer(cfg.pretrained, "cuda")
        with torch.no_grad():
            img, heat, off, wh, mask, _, _ = ad.augment_encode_batch(
                params, *stage_raw(host_batch, torch.device("cuda")),
                target=512)
        arrs = [ad.normalize_device(img, mean, std), heat, off, wh, mask]
        cfg32 = Config(batch_size=16)
        model32 = extras_trainer(cfg32)[0]
        model32.load_state_dict(model.state_dict())
        out["step_errs"] = check_train_step(model, model32, arrs,
                                            Config(batch_size=16, amp=True),
                                            cfg32)
        del model32
        losses = [float(cached(idx, 100 + i, i, True)["total"])
                  for i in range(20)]
        require(all(map(math.isfinite, losses))
                and statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
                "--cache-device: the loss does not fall over 20 steps: %s"
                % losses)
        out["losses"] = losses
        log("train_runtime steps: --device-augment and --cache-device "
            "launch %s per step (as derived); loss over 20 cached steps "
            "%.3f -> %.3f" % (want, losses[0], losses[-1]))

        # telemetry: norms against the state, host syncs per step
        tcfg = dataclasses.replace(cfg, telemetry=True)
        tmodel, topt, _, tstep, _ = runtime_trainer(tcfg)
        host = next(iter(BatchLoader(dataset, load_dataset(cfg)[1], 16,
                                     max_boxes=128, num_workers=8)))
        harrs = stage(host, torch.device("cuda"))
        for i in range(2):  # warm-up: the allocator's blocks, plans
            tstep(i, *harrs)
            step(i, *harrs)
        torch.cuda.synchronize()
        before = [p.detach().clone() for p in tmodel.parameters()]
        tel_syncs, tl = syncs_in(lambda: tstep(2, *harrs))
        after = [p.detach() for p in tmodel.parameters()]
        norm = lambda ts: float(torch.sqrt(sum(  # noqa: E731
            (t.double() ** 2).sum() for t in ts)))
        recomputed = {"grad_norm": norm([p.grad for p in
                                         tmodel.parameters()]),
                      "update_norm": norm([a.double() - b.double()
                                           for a, b in zip(after, before)]),
                      "param_norm": norm(after)}
        tel_errs = {k: abs(float(tl[k]) / recomputed[k] - 1)
                    for k in NORM_KEYS}
        plain_syncs, _ = syncs_in(lambda: step(2, *harrs))
        require(all(v <= 1e-5 for v in tel_errs.values())
                and tel_syncs <= plain_syncs,
                "telemetry: norms off by %s (tol rel 1e-5) or %d host syncs "
                "a step against %d without" % (tel_errs, tel_syncs,
                                                plain_syncs))
        out["telemetry"] = dict(rel_errs=tel_errs, syncs=tel_syncs,
                                plain_syncs=plain_syncs)
        log("train_runtime telemetry: norms vs the state rel %s; host syncs "
            "a step %d with --telemetry, %d without" % (
                {k: "%.2g" % v for k, v in tel_errs.items()}, tel_syncs,
                plain_syncs))
        del tmodel, topt, tstep

        # input paths: images/s and data wait per step, epoch 1 of each
        # after a warm-up epoch 0 (10 steps of b16 each)
        aug = load_dataset(cfg)[1]
        hcfg = dataclasses.replace(cfg, device_augment=False,
                                   cache_device=False)
        paths = {}
        kw = dict(max_boxes=128, seed=cfg.random_seed, num_workers=8)
        proc = ProcessBatchLoader(dataset, aug, 16, **kw)
        specs = (
            ("thread", hcfg, BatchLoader(dataset, aug, 16, **kw),
             make_step_runner(hcfg, step, torch.device("cuda"))),
            ("process", dataclasses.replace(hcfg, loader="process"), proc,
             make_step_runner(hcfg, step, torch.device("cuda"))),
            ("thread+prefetch2", dataclasses.replace(hcfg, device_prefetch=2),
             BatchLoader(dataset, aug, 16, **kw),
             make_step_runner(hcfg, step, torch.device("cuda"))),
            ("device_augment", dataclasses.replace(cfg, cache_device=False),
             BatchLoader(dataset, TestAugmentor(512), 16, raw=True, **kw),
             fused),
            ("device_augment+cache_device", cfg, cache, cached))
        try:
            for name, pcfg, loader, runner in specs:
                epoch_rate(pcfg, loader, runner, 0)
                ips, wait_ms, steps = epoch_rate(pcfg, loader, runner, 1)
                require(steps >= 8, "%s: %d steps" % (name, steps))
                paths[name] = dict(ips=ips, wait_ms=wait_ms, steps=steps)
        finally:
            proc.close()
        h2d = {"host": staged_bytes(stage(host, torch.device("cuda"))),
               "raw": staged_bytes(stage_raw(host_batch,
                                             torch.device("cuda"))),
               "cache": 16 * 8 + 16 * 19 * 4}
        out.update(paths=paths, h2d_bytes=h2d,
                   cache_bytes_per_image=cache.nbytes / len(dataset))
        for name, r in paths.items():
            log("train_runtime input %s: %.1f img/s, data wait %.2f ms a "
                "step over %d steps (b16 512^2 --amp)" % (
                    name, r["ips"], r["wait_ms"], r["steps"]))
        log("train_runtime input: H2D bytes a step host %d, raw %d, cached "
            "%d (indices + augmentation parameters); the cache holds %.0f "
            "bytes an image on the card" % (
                h2d["host"], h2d["raw"], h2d["cache"],
                out["cache_bytes_per_image"]))

        # checkpoints: async bit-equal to sync; the boundary stall
        stalls = {"sync": [], "async": []}
        for i in range(2):
            for mode in ("sync", "async") if i % 2 == 0 else ("async",
                                                              "sync"):
                writer = CheckpointWriter(async_save=mode == "async")
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                writer.save(os.path.join(tmp, "ck_" + mode), i, 7, model,
                            opt, trainer.loss_log, ema)
                stalls[mode].append(time.perf_counter() - t1)
                writer.finalize()
        a = load_checkpoint(os.path.join(tmp, "ck_async", "check_point_2"))
        s = load_checkpoint(os.path.join(tmp, "ck_sync", "check_point_2"))
        same = all(torch.equal(a["state_dict"][k], s["state_dict"][k])
                   for k in s["state_dict"])
        same &= all(torch.equal(a["optimizer"]["state"][k][n], v)
                    for k, st in s["optimizer"]["state"].items()
                    for n, v in st.items())
        require(same, "the async checkpoint's tensors differ from the sync "
                "one's")
        out["ckpt_stall_s"] = {k: statistics.median(v)
                               for k, v in stalls.items()}
        log("train_runtime checkpoint: async tensors bit-equal to sync; "
            "loop stall at the boundary sync %.3f s, async %.3f s (median "
            "of 2, flagship state)" % (out["ckpt_stall_s"]["sync"],
                                       out["ckpt_stall_s"]["async"]))
        del model, opt, ema, step, trainer, fused, cached
        torch.cuda.empty_cache()

        # retention, auto-resume and the span log through train() on a
        # 32-image fixture (2 steps an epoch)
        small = make_synthetic_voc(os.path.join(tmp, "voc32"), num_train=32,
                                   num_test=16, imsize=(512, 512), seed=1)
        ret = os.path.join(tmp, "ret")
        train(runtime_cfg(small, ret, end_epoch=5, keep_ckpt=1,
                          ckpt_interval=2, num_workers=4))
        left = sorted(d for d in os.listdir(ret) if d.startswith("check"))
        require(left == ["check_point_5"], "--keep-ckpt 1 --ckpt-interval 2 "
                "left %s" % left)
        torch.backends.cudnn.deterministic = True
        try:
            clean = train(runtime_cfg(small, os.path.join(tmp, "clean"),
                                      end_epoch=2, num_workers=4))
            spans = os.path.join(tmp, "spans.jsonl")
            faulty = train(runtime_cfg(
                small, os.path.join(tmp, "faulty"), end_epoch=2,
                num_workers=4, fault_inject="1:1", auto_resume=1,
                resume_backoff_s=0.0, loader="process", device_prefetch=2,
                span_log=spans))
        finally:
            torch.backends.cudnn.deterministic = False
        cs, fs = clean["model"].state_dict(), faulty["model"].state_dict()
        diffs = [k for k in cs if not torch.equal(cs[k], fs[k])]
        if diffs:
            wrong = max(float((cs[k].double() - fs[k].double()).norm()
                              / max(float(cs[k].double().norm()), 1e-30))
                        for k in diffs)
            require(wrong <= STEP_TOL["f32_grad"], "auto-resume run off the "
                    "clean run by rel %.3g" % wrong)
            out["auto_resume"] = "within rel %.3g (%d tensors differ)" % (
                wrong, len(diffs))
        else:
            out["auto_resume"] = "bit-equal"
        names = {r.get("name") for r in read_spans(spans)}
        require({"loader-wait", "h2d", "step", "fetch", "checkpoint",
                 "recover:auto-resume"} <= names, "span log names %s"
                % sorted(n for n in names if n))
        log("train_runtime recovery: --fault-inject 1:1 --auto-resume 1 "
            "(--loader process --device-prefetch 2 --span-log) against a "
            "clean run under cudnn.deterministic: %s; retention left %s; "
            "span names %s" % (out["auto_resume"], left,
                               sorted(n for n in names if n)))
        del clean, faulty
        torch.cuda.empty_cache()

        # --async-eval: the subprocess's mAP against evaluate's, and the
        # training rate while it runs
        from real_time_helmet_detection_tpu_torch.evaluate import evaluate
        ckpt = os.path.join(ret, "check_point_5")
        ecfg = runtime_cfg(small, os.path.join(tmp, "ev"), async_eval=True,
                           imsize=512)
        evaluator = AsyncEvaluator(ecfg)
        evaluator.submit(4, ckpt)
        model, opt, ema, step, trainer = runtime_trainer(cfg)
        cached = make_step_runner(cfg, step, torch.device("cuda"),
                                  cache=cache)
        n, t1 = 0, time.perf_counter()
        while evaluator.running() and time.perf_counter() - t1 < 60:
            cached(idx, n, n, True)
            n += 1
            if n % 10 == 0:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        during = 16 * n / (time.perf_counter() - t1)
        evaluator.finalize()
        rec = evaluator.completed[-1]
        require(rec["ok"], "--async-eval subprocess failed: see %s"
                % os.path.join(tmp, "ev"))
        want_map = evaluate(dataclasses.replace(
            ecfg, train_flag=False, async_eval=False, model_load=ckpt,
            save_path=os.path.join(tmp, "ev_inproc")))["map"]
        require(abs(rec["map"] - want_map) <= 1e-3, "--async-eval mAP %.4f, "
                "evaluate %.4f" % (rec["map"], want_map))
        # a checkpoint of 10 steps scores ~0: hold the detections too
        dets = []
        for d in (os.path.join(tmp, "ev", "eval_async", "e4"),
                  os.path.join(tmp, "ev_inproc")):
            with open(os.path.join(d, "prediction_results.pickle"),
                      "rb") as f:
                dets.append(pickle.load(f))
        require(sorted(dets[0]) == sorted(dets[1]) and all(
            np.array_equal(np.asarray(dets[0][k][f]), np.asarray(dets[1][k][f]))
            for k in dets[1] for f in ("box", "cls", "score")),
            "--async-eval detections differ from evaluate's")
        n_dets = sum(len(np.asarray(v["score"])) for v in dets[1].values())
        out["async_eval"] = dict(map=rec["map"], want=want_map,
                                 train_ips_during=during, steps=n)
        log("train_runtime --async-eval: subprocess mAP %.4f vs evaluate "
            "%.4f, its %d detections identical; %d cached train steps ran "
            "beside it at %.1f img/s" % (rec["map"], want_map, n_dets, n,
                                         during))

        # --prewarm: state bit-identical; each bucket's first step cold
        # (the prewarm's own step of it, on zeros) and the first real step
        # after the prewarm (buckets no earlier phase ran)
        mcfg = dataclasses.replace(cfg, multiscale_flag=True)
        first_step = {}
        for i in range(400):
            first_step.setdefault(pick_target(mcfg, i), i)
        model, opt, ema, step, trainer = runtime_trainer(mcfg)
        runner = make_step_runner(mcfg, step, torch.device("cuda"),
                                  cache=cache)
        before = trainer.snapshot()
        cold = runner.prewarm(trainer)
        require(state_equal(before, trainer.snapshot()),
                "--prewarm changed the train state")
        warm = {}
        for b in sorted(cold):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            float(runner(idx, first_step[b], 0, True)["total"])
            warm[b] = time.perf_counter() - t1
        out["prewarm"] = dict(cold_first_step_s=cold, after_prewarm_s=warm)
        log("train_runtime --prewarm: state bit-identical; each bucket's "
            "first step cold (inside the prewarm) %s s, the first real step "
            "after it %s s" % ({b: round(v, 3) for b, v in cold.items()},
                               {b: round(v, 3) for b, v in warm.items()}))

        # the quarantine under --loader process --sentinel
        qproc = ProcessBatchLoader(dataset, PoisonAugmentor(512), 16,
                                   max_boxes=128, seed=cfg.random_seed,
                                   num_workers=4, quarantine=True)
        try:
            got = list(qproc)
        finally:
            qproc.close()
        require(qproc.quarantined == 1 and len(got) == RUNTIME_IMAGES // 16
                - 1, "quarantine: %d dropped, %d batches" % (
                    qproc.quarantined, len(got)))
        log("train_runtime quarantine: a NaN batch dropped and counted (%d "
            "of %d)" % (qproc.quarantined, RUNTIME_IMAGES // 16))
        del model, opt, ema, step, trainer, runner, cache
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        # the process loader's spawn context started multiprocessing's
        # resource tracker, a child process that lives until stopped
        from multiprocessing import resource_tracker
        resource_tracker._resource_tracker._stop()


def eager_map(cfg):
    """(mAP, {image id: (boxes, classes, scores)}) of eager one-shot
    predicts (no serving engine) over cfg's test split, scored and
    rescaled as `evaluate` does: the yardstick of the eval CLI, which
    predicts through the engine."""
    import numpy as np
    from real_time_helmet_detection_tpu_torch.data.eval_loader import \
        eval_batches
    from real_time_helmet_detection_tpu_torch.data.voc import (
        VOCDataset, boxes_from_voc_dict)
    from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state
    from real_time_helmet_detection_tpu_torch.metrics import compute_map
    from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
    predict = make_predict_fn(load_eval_state(cfg), cfg,
                              normalize=cfg.pretrained, device=cfg.device)
    rows, gt_boxes, gt_labels = {}, {}, {}
    t = cfg.imsize
    for batch in eval_batches(VOCDataset(cfg.data, image_set="test"), t,
                              cfg.batch_size):
        b, c, s, v = (x.cpu().numpy() for x in predict(batch.image))
        for j, info in enumerate(batch.infos):
            key = os.path.splitext(info["annotation"]["filename"])[0]
            size = info["annotation"]["size"]
            ow, oh = int(size["width"]), int(size["height"])
            scale = np.array([ow / t, oh / t, ow / t, oh / t], np.float32)
            rows[key] = (b[j][v[j]] * scale, c[j][v[j]], s[j][v[j]])
            gt_boxes[key], gt_labels[key] = boxes_from_voc_dict(info)
    m = compute_map(gt_boxes, gt_labels, *({k: r[i] for k, r in rows.items()}
                                          for i in range(3)),
                    num_cls=cfg.num_cls)["map"]
    return m, rows


def phase_cli(state):
    """The eval CLI (which predicts through the serving engine, 50 ms
    max wait so each loader batch of 16 is one bucket-16 batch) on 32
    synthetic images at 512^2, batch 16, --amp: a printed mAP, 32 txt
    files and the pickle; the mAP within 1e-3 of eager predicts' over the
    same fixture and weights, and every image's detections in the pickle
    equal to the eager predict's at batch 16."""
    import pickle

    import numpy as np
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        make_synthetic_voc
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = make_synthetic_voc(os.path.join(tmp, "voc"), num_train=0,
                                  num_test=32, imsize=(512, 512), seed=0)
        out = os.path.join(tmp, "out")
        cmd = [sys.executable, "-m", "real_time_helmet_detection_tpu_torch",
               "--data", root, "--imsize", "512", "--batch-size", "16",
               "--amp", "--serve-max-wait-ms", "50", "--save-path", out]
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        secs = time.time() - t0
        tail = "\n".join((proc.stdout + proc.stderr).splitlines()[-12:])
        require(proc.returncode == 0, "eval CLI exit %d:\n%s"
                % (proc.returncode, tail))
        map_lines = [l for l in proc.stdout.splitlines() if ": mAP " in l]
        n_txt = len(glob.glob(os.path.join(out, "results", "txt", "*.txt")))
        pickle_ok = os.path.exists(os.path.join(out,
                                                "prediction_results.pickle"))
        require(len(map_lines) == 1 and n_txt == 32 and pickle_ok,
                "eval CLI: mAP lines %d, txt files %d, pickle %s:\n%s"
                % (len(map_lines), n_txt, pickle_ok, tail))
        served = float(map_lines[0].split(": mAP ", 1)[1].split()[0])
        eager, rows = eager_map(Config(data=root, imsize=512, batch_size=16,
                                       amp=True))
        with open(os.path.join(out, "prediction_results.pickle"), "rb") as f:
            got = pickle.load(f)
        same = sorted(got) == sorted(rows) and all(
            all(np.array_equal(x, y) for x, y in zip(
                (got[k]["box"], got[k]["cls"], got[k]["score"]), rows[k]))
            for k in rows)
        n_det = sum(len(r[2]) for r in rows.values())
        require(abs(served - eager) <= 1e-3 and same, "eval CLI through "
                "the engine: mAP %.4f vs %.4f by eager predicts; per-image "
                "detections equal %s" % (served, eager, same))
        state["cli"] = dict(served=served, eager=eager, detections=n_det)
        log("cli: python %s (%.1f s, 32 txt files, pickle written) -> %s; "
            "eager predicts over the same fixture: mAP %.4f, and all %d "
            "detections of the pickle equal to theirs"
            % (" ".join(cmd[1:]).replace(tmp, "<tmp>"), secs,
               map_lines[0].split(": ", 1)[1], eager, n_det))


# ------------------------------------------------------------------ main


# the transfer audit's entries the analysis phase runs on the card
ANALYSIS_ENTRIES = ("predict", "serve_predict[b=1]", "serve_predict[b=2]",
                    "serve_predict[b=4]", "train_step")


def within(got, want, tol):
    return abs(got - want) <= tol * max(want, 1)


def copies_of(entry, attempts=3):
    """(device_records' copies, launch counts) of one run of a transfer
    audit entry on the card after a warm-up one: its host inputs up,
    the program, every output leaf back. Each step opens with 10 ms of
    host time, so that its first upload is not at the recorded window's
    edge; a trace that still holds fewer HtoD records than the entry has
    host inputs (each is one upload) missed one (the profiler has done
    so at a window's first instant) and is taken again, up to `attempts`
    times; the copies of the last trace are what the caller checks."""
    import torch

    def run():
        time.sleep(0.01)
        reset_counts()  # the launches of the recorded run alone
        return [t.cpu() for t in entry.run("cuda")]

    entry.run("cuda")
    torch.cuda.synchronize()
    for attempt in range(attempts):
        _, (_, copies) = profiled(run)
        if copies["HtoD"][0] >= len(entry.host):
            break
        log("  a trace held %d HtoD records of the entry's %d uploads "
            "(attempt %d of %d): %s" % (copies["HtoD"][0], len(entry.host),
                                        attempt + 1, attempts,
                                        copies["names"]))
    return copies, read_counts()


def phase_analysis(state):
    """The transfer audit on the card: each of ANALYSIS_ENTRIES at the
    audit's tiny shapes, its Memcpy HtoD / DtoH records against
    `analysis/transfer_manifest.json` (counts exact, bytes within
    `BYTES_TOL`); then the flagship bf16 b16 512^2 predict and the served
    bucket 16, their copies recorded and their counts held to the tiny
    predict's and serve entries'."""
    import numpy as np
    import torch
    from real_time_helmet_detection_tpu_torch.analysis import \
        transfer_audit as xa
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state
    from real_time_helmet_detection_tpu_torch.predict import (BucketRunner,
                                                              make_predict_fn)
    manifest = xa.load_manifest()["entries"]
    out, launches = {}, {}
    for name in ANALYSIS_ENTRIES:
        copies, launches[name] = copies_of(xa.ENTRY_POINTS[name][0]("cuda"))
        want = manifest[name]
        w = {"HtoD": (want["h2d_fresh"]["leaves"],
                      want["h2d_fresh"]["bytes"]),
             "DtoH": (want["d2h"]["leaves"], want["d2h"]["bytes"])}
        require(all(copies[k][0] == w[k][0]
                    and within(copies[k][1], w[k][1], xa.BYTES_TOL)
                    for k in w),
                "%s on the card: copies %s, manifest %s, every memcpy "
                "record %s" % (name, {k: copies[k] for k in w}, w,
                               copies["names"]))
        out[name] = copies
        log("analysis %s: HtoD %d (%d B), DtoH %d (%d B), as the manifest"
            % (name, copies["HtoD"][0], copies["HtoD"][1],
               copies["DtoH"][0], copies["DtoH"][1]))
    cfg = Config(batch_size=16, imsize=512, amp=True)
    model = load_eval_state(cfg)
    images = np.zeros((16, 512, 512, 3), np.float32)
    predict = make_predict_fn(model, cfg)
    flag = {"predict": xa.Entry(lambda x: tuple(predict.body(x)), (images,),
                                ())}
    served = make_predict_fn(model, cfg, normalize="imagenet")
    runner = BucketRunner(served, 16, (512, 512, 3), torch.uint8)

    def bucket(x):
        runner.input.copy_(x)
        return tuple(runner.run())

    flag["serve_predict[b=16]"] = xa.Entry(
        bucket, (np.zeros((16, 512, 512, 3), np.uint8),), ())
    for name, entry in flag.items():
        with torch.inference_mode():
            copies, _ = copies_of(entry)
        tiny = out["predict" if name == "predict" else "serve_predict[b=1]"]
        require(all(copies[k][0] == tiny[k][0] for k in ("HtoD", "DtoH")),
                "flagship %s: copies %s, the tiny entry's %s"
                % (name, copies, tiny))
        out["flagship " + name] = copies
        log("analysis flagship %s: HtoD %d (%d B), DtoH %d (%d B), the "
            "tiny entry's counts" % (name, copies["HtoD"][0],
                                     copies["HtoD"][1], copies["DtoH"][0],
                                     copies["DtoH"][1]))
    del model, predict, served, runner
    torch.cuda.empty_cache()
    state["analysis"] = dict(copies=out, launches=launches)


def kernel_rows(state):
    """One row per TPU kernel (each function of the JAX package that
    reaches `pl.pallas_call`, #5 being #2's train call): time, bound,
    plain and library time at the largest site (bf16, ReLU; the loss at
    the flagship's f32 output), the comparison's max abs error there,
    and the launches of the kernel's main path — predict for the eval
    forward kernels, one train step for the train kernels and the loss
    (and one `--grad-accum 2` step beside), one eval-mode backward for
    the eval backward kernels; then the int8
    kernels #14 - #16 (no Pallas counterpart) at the throughput tier's
    largest sites, launches from its bf16 int8 predict."""
    errs, timing = state["errs"], state["timing"]
    terrs, ttiming = state["train_errs"], state["train_timing"]
    src = "real_time_helmet_detection_tpu_torch/csrc/%s.cu"
    eerrs, etiming = state["eval_errs"], state["eval_timing"]
    lerrs, ltiming = state["loss_errs"], state["loss_timing"]
    launches = state["launches"]
    predict, train = launches["bf16"], launches["train"]
    eval_grad = launches["eval_grad_bf16"]
    pallas = "real_time_helmet_detection_tpu/ops/pallas/"
    fwd = (timing[("bn_act", "bf16", "ReLU")],
           errs[("bn_act", "bf16", "ReLU", BIG)])
    spec = [  # (row, name, source, replaces, times, max abs err, launches)
        (1, "peak_scores", "peak", "peak.py:68 _peak_kernel",
         timing[("peak_scores", "f32", 3)], errs[("peak_scores", 3,
                                                  "normal")], predict),
        (2, "bn_act", "epilogue", "epilogue.py:138 _fwd_kernel", *fwd,
         predict),
        (3, "bn_eval_bwd", "bn_train", "epilogue.py:144 _bwd_kernel",
         etiming[("bn_eval_bwd", "bf16")],
         eerrs[("bn_eval_bwd", "bf16", "ReLU", BIG)]["sums"][1], eval_grad),
        (4, "bn_stats", "bn_train", "epilogue.py:424 _stats_kernel",
         ttiming[("bn_stats", "bf16")], terrs[("bn_stats", "bf16", BIG)][1],
         train),
        (5, "bn_act", "epilogue",
         "epilogue.py:138 _fwd_kernel (train call, epilogue.py:343)", *fwd,
         train),
        (8, "bn_add_act", "residual", "residual.py:91 _fwd_add_kernel",
         timing[("bn_add_act", "bf16", "ReLU")],
         errs[("bn_add_act", "bf16", "ReLU", BIG)], predict),
        (9, "bn_add_eval_bwd", "bn_train", "residual.py:97 _bwd_add_kernel",
         etiming[("bn_add_eval_bwd", "bf16")],
         eerrs[("bn_add_eval_bwd", "bf16", "ReLU", BIG)]["sums"][1],
         eval_grad),
        (12, "loss_fwd", "loss", "loss.py:86 _fwd_kernel",
         ltiming["loss_fwd"], lerrs[("default", "f32")]["sum_abs"], train),
        (13, "loss_bwd", "loss", "loss.py:126 _bwd_kernel",
         ltiming["loss_bwd"], lerrs[("default", "f32")]["dout_abs"], train),
    ]
    for row, name, line in ((6, "bn_bwd_sums", "epilogue.py:430 "
                             "_bwd_sums_kernel"),
                            (7, "bn_bwd_dx", "epilogue.py:439 "
                             "_bwd_dx_kernel"),
                            (10, "bn_add_bwd_sums", "residual.py:112 "
                             "_bwd_add_sums_kernel"),
                            (11, "bn_add_bwd_dx", "residual.py:121 "
                             "_bwd_add_dx_kernel")):
        spec.append((row, name, "bn_train", line, ttiming[(name, "bf16")],
                     terrs[(name, "bf16", "ReLU", BIG)][1], train))
    rows = []
    for row, name, cu, replaces, t, err, counts in sorted(spec):
        rows.append({
            "name": name if row != 5 else name + "[train]", "route": "cuda",
            "source": src % cu, "replaces": pallas + replaces,
            "launches": counts[name], "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t.get("bound_by", "bytes"),
            "library_ms": t["library_ms"], "table_row": row})
        if counts is train:  # the same kernels under --grad-accum 2 and
            # on the fused input paths of phase train_runtime
            rows[-1]["launches_grad_accum_2"] = launches["accum"][name]
            for path in ("device_augment", "cache_device"):
                rows[-1]["launches_" + path] = launches["train_" + path][name]
            # the gated sentinel window (4 micro-steps), the throughput
            # tier's training (3 steps) and the audit's tiny train step
            extras = state["train_extras"]
            rows[-1].update(
                launches_sentinel_subdiv=extras["sentinel_subdiv"][
                    "launches"][name],
                launches_tier_throughput_train=extras["tier_throughput"][
                    "train_launches"][name],
                launches_analysis_train_step=state["analysis"]["launches"][
                    "train_step"][name])
        if counts is predict:  # the audit's tiny predict on the card
            rows[-1]["launches_analysis_predict"] = state["analysis"][
                "launches"]["predict"][name]
        if "composition_ms" in t:
            rows[-1]["composition_ms"] = t["composition_ms"]
            rows[-1]["launches_eval_grad"] = eval_grad[name]
            rows[-1]["kernel_device_ms"] = t["kernel_device_ms"]
        if name == "bn_act":  # the vector kernel; the scalar one beside
            rows[-1].update(
                launches_vector=counts["bn_act_vec"],
                launches_scalar=counts["bn_act_scalar"],
                scalar_ms=state["epi_sweep"][("bf16", BIG)]["scalar"])
        if name in ("peak_scores", "loss_bwd"):  # the same, by variant
            short = {"peak_scores": "peak", "loss_bwd": "loss_bwd"}[name]
            rows[-1].update(launches_vector=counts[short + "_vec"],
                            launches_scalar=counts[short + "_scalar"],
                            scalar_ms=t["scalar_ms"])
        if name == "peak_scores":  # the bytes the logits' layout forces
            rows[-1]["forced_bound_ms"] = t["forced_ms"]
        if row in (1, 2, 8):  # the served graphs of the new phases
            for key in ("fleet x1", "cascade edge", "cascade quality",
                        "streams edge"):
                rows[-1]["launches_replay_" + key.replace(" ", "_")] = \
                    state[key.split()[0]]["launches"][key].get(name, 0)
        if row in (2, 8):  # the --distill teacher's eval forward, and
            # the training-log snapshot's
            rows[-1]["launches_distill_teacher"] = state["train_extras"][
                "distill"]["teacher_launches"][name]
            rows[-1]["launches_training_log_snapshot"] = launches[
                "snapshot"][name]
        if row == 1:  # the supervisor's triage waiter, per waiter; the
            # throughput tier's eval of its trained checkpoint
            rows[-1]["launches_triage_waiter"] = state["supervisor"][
                "waiter_launches"]
            rows[-1]["launches_tier_throughput_eval"] = state[
                "train_extras"]["tier_throughput"]["eval_launches"][name]
    # the int8 kernels, which have no Pallas counterpart: their main path
    # is the throughput tier's bf16 int8 predict
    qt, qe = state["qtiming"], state["qerrs"]
    int8 = launches["int8 throughput bf16"]
    xla = "real_time_helmet_detection_tpu/"
    for row, name, replaces in (
            (14, "qconv_dense", xla + "models/hourglass.py:287 QuantConv "
             "int8 conv (XLA; no Pallas kernel)"),
            (15, "qconv_dw", xla + "models/hourglass.py:287 QuantConv int8 "
             "conv, groups = C (XLA; no Pallas kernel)"),
            (16, "quantize_act", xla + "ops/quant.py:167 "
             "quantize_activations (XLA; no Pallas kernel)")):
        t = qt[name]
        kind = {"qconv_dense": "dense", "qconv_dw": "dw"}.get(name)
        err = max(v for k, v in qe.items()
                  if (k[0] == kind if kind else k[0] == "quantize_act"))
        rows.append({
            "name": name, "route": "cuda", "source": src % "qconv",
            "replaces": replaces, "launches": int8[name],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "table_row": row,
            "shape": list(t["shape"])})
        # training: one --fwd-dtype int8 step, flagship and edge-arch
        extras = state["train_extras"]["int8"]
        rows[-1].update(
            launches_train_int8=extras["launches"][name],
            launches_train_int8_edge=extras["launches_edge"][name],
            launches_tier_throughput_eval=state["train_extras"][
                "tier_throughput"]["eval_launches"][name])
        if kind:  # the first design's kernel, timed in turns with it
            rows[-1].update(variant=t["variant"], old_variant=t["old_variant"],
                            old_ms=t["old_ms"], host_us=t["host_us"],
                            cudnn_bf16_ms=t["cudnn_bf16_ms"],
                            launches_by_variant={
                                v: int8["qconv_%s_%s" % (kind, v)]
                                for v in (t["variant"], t["old_variant"])})
        # the code outputs (this PR's fused form) and the launches that
        # write them; the quantizer's at two steps
        fused = state["qfused"]
        if kind:
            rows[-1]["launches_codes"] = int8["qconv_%s_codes" % kind]
            f = fused["qconv_%s_codes" % kind]
            rows[-1].update(codes_ms=f["ms"], codes_unfused_ms=f["unfused_ms"],
                            codes_bound_ms=f["bound_ms"],
                            codes_shape=list(f["shape"]),
                            codes_outputs=f["codes"])
        else:
            rows[-1]["launches_dual"] = int8["quantize_act_dual"]
            rows[-1]["launches_flagship_int8"] = launches[
                "int8 flagship-int8 bf16"]["quantize_act"]
        if name == "qconv_dense":
            for key, tag in (("qconv_dense_3x3", "3x3"),
                             ("qconv_dense_3x3_128", "3x3_128")):
                f = qt[key]
                rows[-1].update({
                    "ms_" + tag: f["ms"], "old_ms_" + tag: f["old_ms"],
                    "bound_ms_" + tag: f["bound_ms"],
                    "bound_by_" + tag: f["bound_by"],
                    "library_ms_" + tag: f["library_ms"],
                    "cudnn_bf16_ms_" + tag: f["cudnn_bf16_ms"],
                    "shape_" + tag: list(f["shape"])})
    # the abs-max of the --fwd-dtype int8 step (XLA's in JAX; added with
    # #16's redesign): its main path is that step
    t = qt["abs_max"]
    extras = state["train_extras"]["int8"]
    rows.append({
        "name": "abs_max", "route": "cuda", "source": src % "qconv",
        "replaces": xla + "ops/quant.py:217 make_ste_conv "
        "jnp.max(jnp.abs(x)) (XLA; no Pallas kernel)",
        "launches": extras["launches"]["abs_max"],
        "max_abs_err": max(v for k, v in qe.items() if k[0] == "abs_max"),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "table_row": 16, "shape": list(t["shape"]),
        "launches_train_int8_edge": extras["launches_edge"]["abs_max"]})
    return rows


def become_subreaper() -> bool:
    """Make this process the reaper of its orphaned descendants
    (prctl PR_SET_CHILD_SUBREAPER): a process whose parent ended becomes
    this one's child instead of init's, so `leftovers` sees it."""
    import ctypes
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        return libc.prctl(36, 1, 0, 0, 0) == 0  # PR_SET_CHILD_SUBREAPER
    except (OSError, AttributeError):
        return False


def _children():
    """{pid: (state, "pid (name) command")} of this process's children
    but the `BACKGROUND` ones."""
    out = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % pid) as f:
                head, tail = f.read().rsplit(")", 1)
        except (OSError, ValueError):
            continue
        fields = tail.split()
        if int(fields[1]) != os.getpid() or int(pid) in BACKGROUND:
            continue
        try:
            with open("/proc/%s/cmdline" % pid, "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            cmd = ""
        out[int(pid)] = (fields[0], "%s (%s) %s" % (
            pid, head.split("(", 1)[1], cmd[:120].strip()))
    return out


def leftovers():
    """What would outlive a phase: live non-daemon threads besides the
    main one (interpreter shutdown joins them), and child processes of
    this process, zombies included (unreaped), as "pid (name) command";
    with `become_subreaper` the children include orphaned descendants."""
    import threading
    threads = [t.name for t in threading.enumerate()
               if t is not threading.main_thread() and not t.daemon
               and t.is_alive()]
    return {"threads": threads,
            "children": [c for _, c in _children().values()]}


def reap_zombies():
    """Reap this process's children that have ended (orphans adopted as
    the subreaper have no other parent to wait for them); their
    "pid (name)"."""
    reaped = []
    for pid, (st, desc) in _children().items():
        if st == "Z":
            try:
                os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                continue
            reaped.append(desc.split(")", 1)[0] + ")")
    return reaped


def settle(before, grace_s=10.0, seen=None):
    """What is left beyond `before` once it has had `grace_s` to end
    (an orphan ends on its own once it sees its parent gone); ended
    processes are reaped, not counted. `seen`, a dict, gets what had to
    be waited for ("waited", with "wait_s") and what was reaped."""
    t0 = time.time()
    while True:
        reaped = reap_zombies()
        new = {k: sorted(set(v) - set(before[k]))
               for k, v in leftovers().items()}
        if seen is not None:
            seen.setdefault("reaped", []).extend(reaped)
            if any(new.values()) and "waited" not in seen:
                seen["waited"] = new
        if not any(new.values()) or time.time() - t0 >= grace_s:
            if seen is not None and "waited" in seen:
                seen["wait_s"] = round(time.time() - t0, 2)
            return new
        time.sleep(0.2)


def stop_left(before) -> None:
    """SIGKILL the child processes not in `before` (orphans adopted as
    the subreaper included) with the process groups they lead (a job's),
    and reap them, so that a failed or stopped run leaves none running;
    the `BACKGROUND` ones first."""
    import signal
    stop_background()
    old = {c.split(" ", 1)[0] for c in before["children"]}
    for _ in range(10):
        pids = [p for p in _children() if str(p) not in old]
        if not pids:
            return
        for pid in pids:
            try:
                if os.getpgid(pid) == pid:
                    os.killpg(pid, signal.SIGKILL)
                os.kill(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        time.sleep(0.2)
        reap_zombies()


class Stopped(BaseException):
    """SIGTERM or SIGHUP: the run stops, and what it started with it."""


def _stop_on_signal(signum, frame):
    raise Stopped("signal %d" % signum)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %s (default: all)"
                    % ",".join(PHASES))
    ap.add_argument("--export-worker", nargs=2, default=None,
                    metavar=("LABEL", "DIR"),
                    help="run one EXPORT_RUNS export of phase export")
    ap.add_argument("--ddp-worker", nargs=4, default=None,
                    metavar=("RANK", "WORLD", "PORT", "DIR"),
                    help="run one rank of phase ddp's world-2 step")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if args.export_worker:  # beside the run's phases: the lowest priority
        os.nice(19)
    try:
        import torch
    except ImportError:
        log("FAIL: torch is not importable")
        return 1
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False: this smoke run needs "
            "a CUDA card")
        return 1
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    try:
        import real_time_helmet_detection_tpu_torch  # noqa: F401
    except ImportError as e:
        log("FAIL: the port's package is not next to chip_smoke.py (%s)" % e)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.ddp_worker:
        rank, world, port, out_dir = args.ddp_worker
        ddp_worker(int(rank), int(world), int(port), out_dir)
        return 0
    if args.export_worker:
        export_worker(*args.export_worker)
        return 0
    import signal
    become_subreaper()
    for sig in (signal.SIGTERM, signal.SIGHUP):
        signal.signal(sig, _stop_on_signal)
    state, leaks = {}, {}
    t_all = time.time()
    at_start = leftovers()
    for name in PHASES:
        if name not in phases and name != "identity":
            continue
        t0 = time.time()
        before = leftovers()
        try:
            globals()["phase_" + name](state)
        except SmokeFailure as e:
            log("FAIL [%s]: %s" % (name, e))
            stop_left(at_start)
            drop_round(state)
            return 1
        except Exception as e:  # a fault of the phase itself: say where
            traceback.print_exc()
            log("FAIL [%s]: %s: %s" % (name, type(e).__name__, e))
            stop_left(at_start)
            drop_round(state)
            return 1
        except (Stopped, KeyboardInterrupt) as e:
            log("FAIL [%s]: stopped (%s); stopping what the run started"
                % (name, e or "SIGINT"))
            stop_left(at_start)
            drop_round(state)
            return 1
        seen = {}
        new = settle(before, seen=seen)
        if seen.get("reaped") or seen.get("waited"):
            log("phase %s: reaped ended children %s; waited %s s for %s"
                % (name, seen.get("reaped"), seen.get("wait_s"),
                   seen.get("waited")))
        if any(new.values()):
            leaks[name] = new
            log("phase %s left %s" % (name, new))
        log("phase %s: %.1f s" % (name, time.time() - t0))
    log("all phases: %.1f s" % (time.time() - t_all))
    drop_round(state)
    stop_background()
    seen = {}
    left = settle(at_start, seen=seen)
    if seen.get("reaped") or seen.get("waited"):
        log("at the end: reaped %s; waited %s s for %s" % (
            seen.get("reaped"), seen.get("wait_s"), seen.get("waited")))
    if leaks or any(left.values()):  # a phase must close or reap its own
        log("FAIL: phases left threads or processes: %s; still running at "
            "the end: %s" % (leaks, left))
        stop_left(at_start)
        drop_round(state)
        return 1
    log(state["card"])
    if not set(PHASES) <= set(phases):
        log("partial run (%s): passed; no result line" % ",".join(phases))
        return 0
    log(json.dumps({"kernels": kernel_rows(state)}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": state["kind"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
