"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases build,train_kernels   # a short check

Drives the port's paths at the flagship width — eval/predict (the
JAX package's eval command, ref main.py:32-37 -> evaluate.py:121
`evaluate`), training (ref main.py:25-27 -> train.py:1698 `train`,
the flagship `--train-flag --batch-size 16 --amp --num-stack 1`, with
the fused loss of ref train.py:274-278) and a gradient through the
eval-mode model (`jax.grad` of `model.apply(train=False)`) — and checks
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
   the vector kernel, 17 residual tail, 1 peak, no train kernel), logits
   of the whole batch
   and Detections against the same path with every kernel swapped for
   its plain version, peak memory, images/s as the median of 5 windows
   of about 2 s each (kernel and plain windows alternate), and a small
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
   images/s over alternating ~2 s windows, peak memory; then one f32
   step;
12. eval_grad: the eval-mode BN backward kernels against their plain
   versions at every BN site shape, f32 and bf16, every activation (dx
   and ds bit-equal for ReLU/Linear, Mish as in 3, partials within 1e-5
   of the sum of |terms|); then the flagship model in eval mode at b16
   512^2, the fused loss and backward(), f32 and bf16, through the
   kernels and through the plain versions: launch counts (20 + 17 eval
   backward, the loss kernels once each), a non-zero gradient for every
   parameter, f32 gradient rel L2 <= 1e-5, bf16 no further from the f32
   plain gradient than 1.5x the bf16 plain path;
13. eval_timing: the eval backward kernels at the largest site beside
   their bounds, the plain versions and ATen's BN backward (Linear);
14. a torch.profiler trace (CUDA activity) of a predict and of a train
   step: device time by kernel group and the idle share against the
   untraced walls of phases 5 and 11, and the train step's phases by
   CUDA events;
15. the eval CLI end to end on a synthetic VOC fixture (32 images at
   512^2, batch 16, --amp) to a printed mAP, txt files and pickle;
16. train_cli: `--train-flag` for one epoch on a 32-image 512^2 fixture,
   then the eval CLI on the weights it wrote.

Any failure exits non-zero. Each phase prints its wall time. The last
three lines are the card's name and power limit, one JSON object of
per-kernel numbers (all 13 TPU kernels), and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PHASES = ("identity", "build", "kernels", "timing", "main", "states",
          "train_kernels", "train_timing", "loss_kernels", "loss_timing",
          "train_main", "eval_grad", "eval_timing", "profile", "cli",
          "train_cli")


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
                                                          peak, residual)
    return swapped([
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


def site_bytes(totals):
    """Add up, per wrapper, the bytes each call must move (inputs read
    once, outputs written once; the (C,) vectors and partials are
    negligible) while the block runs."""
    from real_time_helmet_detection_tpu_torch.ops import epilogue, residual
    # wrapper -> activation-sized tensors moved per call
    moved = {(epilogue, "bn_act"): 2, (residual, "bn_add_act"): 3,
             (epilogue, "bn_stats"): 1, (epilogue, "bn_bwd_sums"): 2,
             (residual, "bn_add_bwd_sums"): 3, (epilogue, "bn_bwd_dx"): 3,
             (residual, "bn_add_bwd_dx"): 5}

    def counting(mod, name, n):
        real = getattr(mod, name)

        def wrapper(x, *args):
            totals[name] = totals.get(name, 0) + n * x.numel() \
                * x.element_size()
            return real(x, *args)
        return wrapper
    return swapped([(mod, name, counting(mod, name, n))
                    for (mod, name), n in moved.items()], totals)


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
}


def _ops():
    from real_time_helmet_detection_tpu_torch import ops
    from real_time_helmet_detection_tpu_torch.ops import (  # noqa: F401
        epilogue, loss, peak, residual)
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


def detections_match(a, b, min_score=0.1):
    """Every valid detection scoring >= min_score in `a` has one in `b`
    with the same class, |score difference| <= 1e-3 and IoU >= 0.99 (or,
    for a box of zero area, corners within 1e-2). Returns the number of
    detections checked."""
    import numpy as np
    checked = 0
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
            hit = (bc == c) & (np.abs(bs - s) <= 1e-3) & close
            require(bool(hit.any()), "detection %s cls %d score %.4f of "
                    "image %d has no match" % (box, c, s, i))
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


def throughput(predict, images, windows=5, window_s=2.0):
    """Predict images/s of the kernel path and of the plain-version path,
    in `windows` alternating windows of about `window_s` seconds each (so
    host noise falls on both alike). Returns, per path, the list of
    per-window images/s and the median ms per predict."""
    import statistics
    import torch

    def one_window(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            predict(images)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    n = max(10, int(window_s / (one_window(3) / 3)))
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
    import numpy as np
    import torch
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state
    from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
    images = np.random.default_rng(0).integers(
        0, 256, (16, 512, 512, 3), dtype=np.uint8)
    want = dict.fromkeys(COUNTERS, 0)  # predict runs no train kernel
    want.update(bn_act=20, bn_act_vec=20, bn_add_act=17, peak_scores=1,
                peak_vec=1)
    for amp in (False, True):
        tag = "bf16" if amp else "f32"
        cfg = Config(batch_size=16, imsize=512, amp=amp)
        model = perturb_bn(load_eval_state(cfg), seed=3)
        predict = make_predict_fn(model, cfg, normalize="imagenet")
        predict(images)  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        reset_counts()
        dets = predict(images)  # THE main-path run the counts read
        torch.cuda.synchronize()
        counts = read_counts()
        require(counts == want, "%s launches per forward %s, want %s"
                % (tag, counts, want))
        state.setdefault("launches", {})[tag] = counts
        require(tuple(dets.boxes.shape) == (16, 100, 4)
                and bool(torch.isfinite(dets.boxes).all())
                and bool(torch.isfinite(dets.scores).all()),
                "%s detections malformed" % tag)
        # logits of the whole batch through kernel and plain paths
        lk, lp = full_batch_logits(model, images)
        tol = 1e-4 if not amp else 2e-2
        lerr = float((lk - lp).abs().max())
        require(bool(torch.isfinite(lk).all()) and lk.shape == (16, 1, 128,
                                                                 128, 6),
                "%s logits malformed" % tag)
        require(bool(torch.allclose(lk, lp, rtol=tol, atol=tol)),
                "%s logits kernel vs plain: max abs err %g > tol %g"
                % (tag, lerr, tol))
        with plain_kernels():
            dets_plain = predict(images)
        checked = detections_match(dets, dets_plain) \
            + detections_match(dets_plain, dets)
        # peak memory of one kernel-path predict, then throughput
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        predict(images)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rates = throughput(predict, images)
        state.setdefault("main", {})[tag] = dict(
            rates=rates, peak_gb=peak_gb, logit_err=lerr,
            valid=int(dets.valid.sum()), checked=checked)
        log("main %s: launches %s per forward; logits (16 images) kernel vs "
            "plain max abs err %g (tol %g, bit-equal %s); %d detections >= "
            "0.1 matched both ways; %d valid after NMS; peak memory %.2f GB"
            % (tag, counts, lerr, tol, torch.equal(lk, lp), checked,
               int(dets.valid.sum()), peak_gb))
        for path, r in rates.items():
            log("main %s: predict b16 512^2 with %s: median %.1f img/s "
                "(%.2f ms per predict), min %.1f, max %.1f over %d windows "
                "of %d predicts: %s" % (
                    tag, path, r["median_ips"], r["ms_per_predict"],
                    min(r["ips"]), max(r["ips"]), len(r["ips"]),
                    r["predicts_per_window"],
                    ", ".join("%.1f" % v for v in r["ips"])))
        del model, predict, lk, lp
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
    from real_time_helmet_detection_tpu_torch.evaluate import init_weights
    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        build_model
    from real_time_helmet_detection_tpu_torch.ops import epilogue, residual
    from real_time_helmet_detection_tpu_torch.ops.loss import \
        fused_detection_loss
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
    want = dict.fromkeys(COUNTERS, 0)
    want.update(bn_act=20, bn_act_vec=20, bn_add_act=17, bn_eval_bwd=20,
                bn_add_eval_bwd=17, loss_fwd=1, loss_bwd=1, loss_bwd_vec=1)
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for amp in (False, True):
            tag = "bf16" if amp else "f32"
            cfg = Config(batch_size=16, amp=amp)
            model = build_model(cfg, dtype=torch.bfloat16 if amp else None)
            model = perturb_bn(init_weights(model, 0), seed=5).cuda().eval()

            def backward():
                model.zero_grad(set_to_none=True)
                total = fused_detection_loss(model(arrs[0]),
                                             *arrs[1:])["total"]
                total.backward()
                torch.cuda.synchronize()
                return total.item(), {n: p.grad.detach().clone()
                                      for n, p in model.named_parameters()}

            backward()  # warm-up: cuDNN plans, allocator
            reset_counts()
            lk, gk = backward()  # THE eval-grad run the counts read
            counts = read_counts()
            with plain_kernels():
                lp, gp = backward()
            require(counts == want, "%s launches per eval backward %s, want "
                    "%s" % (tag, counts, want))
            state.setdefault("launches", {})["eval_grad_" + tag] = counts
            zero = [n for n, g in gk.items() if float(g.abs().max()) == 0.0]
            require(not zero and len(gk) == len(list(model.parameters())),
                    "%s eval backward left parameters without a gradient: "
                    "%s" % (tag, zero))
            runs[tag] = (lk, gk, lp, gp)
            del model
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    lk32, gk32, lp32, gp32 = runs["f32"]
    lk16, gk16, lp16, gp16 = runs["bf16"]
    e = dict(f32_loss=abs(lk32 - lp32) / abs(lp32),
             f32_grad=rel_l2(gk32, gp32),
             bf16_loss=abs(lk16 - lp16) / abs(lp16),
             bf16_grad_vs_f32=(rel_l2(gk16, gp32), rel_l2(gp16, gp32)))
    state["eval_grad"] = dict(errs=e, params=len(gk32))
    log("eval_grad model (b16 512^2, eval mode, fused loss, backward): "
        "launches %s; all %d parameters have a non-zero gradient; f32 loss "
        "%.7f vs %.7f plain, gradient rel L2 kernels vs plain %.3g (tol "
        "1e-5); bf16 loss %.6f vs %.6f, gradient rel L2 to the f32 plain "
        "path: kernels %.3g, plain %.3g (kernels at most 1.5x plain)" % (
            state["launches"]["eval_grad_bf16"], len(gk32), lk32, lp32,
            e["f32_grad"], lk16, lp16, *e["bf16_grad_vs_f32"]))
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


def make_trainer(cfg, seed=0):
    """The flagship model with seeded weights on the card in train mode,
    its optimizer and the port's train step."""
    import torch
    from real_time_helmet_detection_tpu_torch.evaluate import init_weights
    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        build_model
    from real_time_helmet_detection_tpu_torch.optim import (
        build_optimizer, make_lr_schedule)
    from real_time_helmet_detection_tpu_torch.train import make_train_step
    dtype = torch.bfloat16 if cfg.amp else None
    model = init_weights(build_model(cfg, dtype=dtype), seed)
    model = model.cuda().train()
    opt = build_optimizer(cfg, model.parameters())
    return model, opt, make_train_step(model, opt,
                                       make_lr_schedule(cfg, 1000), cfg)


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


def train_throughput(step, arrs, windows=5, window_s=2.0):
    """Train images/s of the kernel path and the plain-version path in
    `windows` alternating windows of about `window_s` s each."""
    import statistics
    import torch
    count = [0]

    def one_window(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(count[0], *arrs)
            count[0] += 1
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    n = max(5, int(window_s / (one_window(3) / 3)))
    rates = {"kernels": [], "plain": []}
    batch = arrs[0].shape[0]
    for _ in range(windows):
        rates["kernels"].append(batch * n / one_window(n))
        with plain_kernels():
            rates["plain"].append(batch * n / one_window(n))
    return {path: dict(ips=r, median_ips=statistics.median(r),
                       ms_per_step=1e3 * batch / statistics.median(r),
                       steps_per_window=n)
            for path, r in rates.items()}


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
    model, opt, step = make_trainer(cfg)
    arrs = train_batch()
    # warm-up on a throwaway copy of the weights: cuDNN plans, allocator
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    saved_opt = opt.state_dict()
    step(0, *arrs)
    torch.cuda.synchronize()
    model.load_state_dict(saved)
    opt.load_state_dict(saved_opt)
    cfg32 = Config(batch_size=16)
    model32, opt32, step32 = make_trainer(cfg32)
    model32.load_state_dict(model.state_dict())
    errs = check_train_step(model, model32, arrs, cfg, cfg32)
    reset_counts()
    step(0, *arrs)  # THE train-path run the counts read
    torch.cuda.synchronize()
    counts = read_counts()
    from real_time_helmet_detection_tpu_torch.ops import epilogue
    conversions = epilogue.grad_conversions
    want = dict.fromkeys(COUNTERS, 0)
    want.update(bn_act=20, bn_act_vec=20, bn_add_act=17, bn_stats=37,
                bn_bwd_sums=20, bn_add_bwd_sums=17, bn_bwd_dx=20,
                bn_add_bwd_dx=17, loss_fwd=1, loss_bwd=1, loss_bwd_vec=1)
    require(counts == want, "launches per train step %s, want %s"
            % (counts, want))
    state.setdefault("launches", {})["train"] = counts
    losses = [float(step(i + 1, *arrs)["total"]) for i in range(20)]
    require(all(map(math.isfinite, losses))
            and statistics.mean(losses[-5:]) < statistics.mean(losses[:5])
            and losses[-1] < losses[0],
            "loss does not fall over 20 steps on one batch: %s" % losses)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(21, *arrs)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rates = train_throughput(step, arrs)
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


# cuDNN's convolution kernels: implicit GEMMs (fprop, dgrad, wgrad), FFT
# and Winograd algorithms and their layout transforms
CONV_KEYS = ("conv", "xmma", "cudnn", "gemm", "cutlass", "fft", "winograd",
             "wgrad", "dgrad", "pointwise_mult_and_sum_complex")


def trace_device_ms(run, reps=3, counts=None):
    """Call `run(i)` for i < reps under torch.profiler (CUDA activity
    only): (device ms per call by kernel name, traced wall ms per call);
    `counts`, a dict when given, gets device operations per call by
    name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for i in range(reps):
            run(i)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / reps
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.key] = by_name.get(ev.key, 0.0) \
                + ev.self_device_time_total / 1e3 / reps
            if counts is not None:
                counts[ev.key] = counts.get(ev.key, 0) + ev.count / reps
    return by_name, traced_ms


def group_device_ms(by_name, kernels):
    """Device ms by group: each of our `kernels` (a substring of the
    kernel's name), convolution, the optimizer's foreach kernels, copies,
    the rest."""
    groups = dict.fromkeys(kernels, 0.0)
    groups.update({"convolution": 0.0, "optimizer (foreach)": 0.0,
                   "copies": 0.0, "other": 0.0})
    for name, ms in by_name.items():
        low = name.lower()
        hit = next((k for k in kernels if k in name), None)
        if hit:
            groups[hit] += ms
        elif any(k in low for k in CONV_KEYS):
            groups["convolution"] += ms
        elif "multi_tensor_apply" in low or "foreach" in low:
            groups["optimizer (foreach)"] += ms
        elif low.startswith("memcpy") or low.startswith("memset"):
            groups["copies"] += ms
        else:
            groups["other"] += ms
    return groups


def log_profile(what, wall_ms, traced_ms, by_name, groups, top):
    busy = sum(by_name.values())
    log("profile %s: wall %.2f (untraced; %.2f under the profiler), device "
        "busy %.2f, idle share %.1f%%; %s" % (
            what, wall_ms, traced_ms, busy,
            100.0 * max(0.0, 1 - busy / wall_ms),
            ", ".join("%s %.2f (%.1f%%)" % (k, v, 100 * v / busy)
                      for k, v in groups.items() if v)))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log("    %8.3f ms  %s" % (ms, name[:110]))


def profile_train(state):
    """Where the device time of one flagship bf16 train step goes: kernel
    groups from a torch.profiler trace (CUDA activity) of 3 steps, the
    step's phases (forward, loss, backward, optimizer) from CUDA events
    around one untraced step, and the idle share against phase
    train_main's untraced wall."""
    import torch
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.ops.loss import \
        fused_detection_loss
    from real_time_helmet_detection_tpu_torch.optim import set_lr
    cfg = Config(batch_size=16, amp=True)
    model, opt, step = make_trainer(cfg)
    arrs = train_batch()
    for i in range(2):
        step(i, *arrs)
    with site_bytes({}) as nbytes:
        step(2, *arrs)
    # phases of one untraced step, CUDA events
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    set_lr(opt, cfg.lr)
    opt.zero_grad(set_to_none=True)
    ev[0].record()
    out = model(arrs[0])
    ev[1].record()
    total = fused_detection_loss(
        out, *arrs[1:], size_weight=cfg.size_weight,
        hm_weight=cfg.hm_weight, offset_weight=cfg.offset_weight,
        focal_alpha=cfg.focal_alpha, focal_beta=cfg.focal_beta)["total"]
    ev[2].record()
    total.backward()
    ev[3].record()
    opt.step()
    ev[4].record()
    ev[4].synchronize()
    phases = {name: ev[i].elapsed_time(ev[i + 1]) for i, name in
              enumerate(("forward", "loss", "backward", "optimizer"))}
    by_name, traced_ms = trace_device_ms(lambda i: step(3 + i, *arrs))
    busy = sum(by_name.values())
    wall_ms = state["train_main"]["rates"]["kernels"]["ms_per_step"]
    if busy == 0.0:
        log("profile train: the profiler saw no device time; breakdown "
            "not measured (traced wall %.2f ms per step)" % traced_ms)
        return
    groups = group_device_ms(by_name, (
        "bn_add_act_kernel", "bn_act_vec_kernel", "bn_act_kernel",
        "bn_stats_kernel", "bn_bwd_sums_kernel", "bn_bwd_dx_kernel",
        "loss_fwd_kernel", "loss_bwd_vec_kernel", "loss_bwd_kernel"))
    state["profile_train"] = dict(wall_ms=wall_ms, traced_ms=traced_ms,
                                  busy_ms=busy, groups=groups, phases=phases)
    log("    step phases by CUDA events (one untraced step): %s"
        % ", ".join("%s %.2f ms" % kv for kv in phases.items()))
    log("    bound over the step's BN sites (bytes / 3.35 TB/s): %s"
        % ", ".join("%s %.3f ms" % (k, v / HBM_BYTES_PER_S * 1e3)
                    for k, v in sorted(nbytes.items())))
    log_profile("train bf16 (ms per step of 16 x 512^2, wall from phase "
                "train_main)", wall_ms, traced_ms, by_name, groups, top=10)
    del model, opt, step, arrs
    torch.cuda.empty_cache()


def phase_train_cli(state):
    """`--train-flag` for one epoch on a 32-image 512^2 synthetic fixture
    (--amp, batch 16), then the eval CLI on the weights it wrote."""
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
        for what, cmd in (("train", train_cmd), ("eval", eval_cmd)):
            t0 = time.time()
            proc = subprocess.run(cmd, cwd=REPO, capture_output=True,
                                  text=True, timeout=600)
            secs = time.time() - t0
            tail = "\n".join((proc.stdout + proc.stderr).splitlines()[-12:])
            require(proc.returncode == 0, "%s CLI exit %d:\n%s"
                    % (what, proc.returncode, tail))
            if what == "train":
                iters = [l for l in proc.stdout.splitlines() if " iter " in l]
                require(len(iters) == 2 and os.path.exists(weights)
                        and os.path.exists(os.path.join(
                            out, "check_point_1", "checkpoint.pt")),
                        "train CLI: %d iteration lines, checkpoint %s:\n%s"
                        % (len(iters), os.path.exists(weights), tail))
                shown = iters[-1].split(", ", 1)[1]
            else:
                maps = [l for l in proc.stdout.splitlines() if ": mAP " in l]
                require(len(maps) == 1, "eval CLI printed no mAP:\n%s" % tail)
                shown = maps[0].split(": ", 1)[1]
            log("train_cli %s: python %s (%.1f s) -> %s" % (
                what, " ".join(cmd[1:]).replace(tmp, "<tmp>"), secs, shown))


def phase_profile(state):
    """Where the device time of one flagship predict goes, from a
    torch.profiler trace (CUDA activity only) of 3 predicts: our kernels,
    convolutions, the rest. The device's idle share is 1 - busy / wall,
    with wall the median ms per predict of phase main, taken without the
    profiler: the profiler's own host overhead stretches the traced
    predicts' wall, which it reports beside."""
    import numpy as np
    import torch
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state
    from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
    require("main" in state and "train_main" in state,
            "phase profile reads the predict and train-step times of "
            "phases main and train_main: run all three")
    images = np.random.default_rng(0).integers(
        0, 256, (16, 512, 512, 3), dtype=np.uint8)
    for amp in (False, True):
        tag = "bf16" if amp else "f32"
        wall_ms = state["main"][tag]["rates"]["kernels"]["ms_per_predict"]
        cfg = Config(batch_size=16, imsize=512, amp=amp)
        predict = make_predict_fn(perturb_bn(load_eval_state(cfg), seed=3),
                                  cfg, normalize="imagenet")
        predict(images)
        with site_bytes({}) as nbytes:
            predict(images)
        by_name, traced_ms = trace_device_ms(lambda i: predict(images))
        busy = sum(by_name.values())
        if busy == 0.0:
            log("profile %s: the profiler saw no device time; breakdown "
                "not measured (traced wall %.2f ms per predict)"
                % (tag, traced_ms))
            continue
        groups = group_device_ms(by_name, ("bn_add_act_kernel",
                                           "bn_act_vec_kernel",
                                           "bn_act_kernel", "peak_kernel"))
        state.setdefault("profile", {})[tag] = dict(
            wall_ms=wall_ms, traced_ms=traced_ms, busy_ms=busy,
            groups=groups)
        log("    bound over the forward's sites (bytes / 3.35 TB/s): "
            "bn_act %.3f ms, bn_add_act %.3f ms"
            % tuple(nbytes[k] / HBM_BYTES_PER_S * 1e3
                    for k in ("bn_act", "bn_add_act")))
        log_profile("%s (ms per predict of 16 x 512^2, wall from phase "
                    "main)" % tag, wall_ms, traced_ms, by_name, groups,
                    top=8)
        del predict
        torch.cuda.empty_cache()

    profile_train(state)


def phase_cli(state):
    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        make_synthetic_voc
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = make_synthetic_voc(os.path.join(tmp, "voc"), num_train=0,
                                  num_test=32, imsize=(512, 512), seed=0)
        out = os.path.join(tmp, "out")
        cmd = [sys.executable, "-m", "real_time_helmet_detection_tpu_torch",
               "--data", root, "--imsize", "512", "--batch-size", "16",
               "--amp", "--save-path", out]
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
        log("cli: python %s (%.1f s, 32 txt files, pickle written) -> %s"
            % (" ".join(cmd[1:]).replace(tmp, "<tmp>"), secs,
               map_lines[0].split(": ", 1)[1]))


# ------------------------------------------------------------------ main


def kernel_rows(state):
    """One row per TPU kernel (each function of the JAX package that
    reaches `pl.pallas_call`, #5 being #2's train call): time, bound,
    plain and library time at the largest site (bf16, ReLU; the loss at
    the flagship's f32 output), the comparison's max abs error there,
    and the launches of the kernel's main path — predict for the eval
    forward kernels, one train step for the train kernels and the loss,
    one eval-mode backward for the eval backward kernels."""
    errs, timing = state["errs"], state["timing"]
    terrs, ttiming = state["train_errs"], state["train_timing"]
    eerrs, etiming = state["eval_errs"], state["eval_timing"]
    lerrs, ltiming = state["loss_errs"], state["loss_timing"]
    launches = state["launches"]
    predict, train = launches["bf16"], launches["train"]
    eval_grad = launches["eval_grad_bf16"]
    src = "real_time_helmet_detection_tpu_torch/csrc/%s.cu"
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
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %s (default: all)"
                    % ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
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
    state = {}
    t_all = time.time()
    for name in PHASES:
        if name not in phases and name != "identity":
            continue
        t0 = time.time()
        try:
            globals()["phase_" + name](state)
        except SmokeFailure as e:
            log("FAIL [%s]: %s" % (name, e))
            return 1
        except Exception as e:  # a fault of the phase itself: say where
            traceback.print_exc()
            log("FAIL [%s]: %s: %s" % (name, type(e).__name__, e))
            return 1
        log("phase %s: %.1f s" % (name, time.time() - t0))
    log("all phases: %.1f s" % (time.time() - t_all))
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
