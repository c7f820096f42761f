"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # every phase, one card

Drives the port's eval/predict path (the JAX package's eval command,
ref main.py:32-37 -> evaluate.py:121 `evaluate`) at the flagship width
and checks every hand-written kernel of that path against its plain
PyTorch version on the card:

1. card identity (torch + nvidia-smi);
2. build the kernels from csrc/ (one nvcc per source, in parallel) and
   print nvcc's `-Xptxas -v` register / shared-memory / spill report;
3. each kernel against its plain version at the main path's shapes, f32
   and bf16, every activation, pool sizes 3 and 5 — bit-equal for the
   peak test and the ReLU/Linear epilogue and residual tail; Mish within
   rtol 1e-6 (f32) or one bf16 ulp (bf16);
4. kernel time (CUDA graph replay, CUDA events) beside the least time
   the card could take (bytes / 3.35 TB/s), the plain version's time and
   the time of a one-call PyTorch equivalent where one exists;
5. the main path, batch 16, 512^2, 1 stack, 128 channels, seeded
   weights, f32 and bf16: launch counts per forward (20 epilogue, 17
   residual tail, 1 peak), logits of the whole batch and Detections
   against the same path with every kernel swapped for its plain
   version, peak memory, images/s as the median of 5 windows of about
   2 s each (kernel and plain windows alternate), and a small model on
   the card against the CPU path;
6. the same kernel-vs-plain rule under two BN states with larger
   logits, where scores round to 1 and ties decide the order;
7. a torch.profiler trace (CUDA activity) of the main path: device time
   by kernel group, and the device's idle share against phase 5's
   untraced wall time;
8. the eval CLI end to end on a synthetic VOC fixture (32 images at
   512^2, batch 16, --amp) to a printed mAP, txt files and pickle.

Any failure exits non-zero. The last three lines are the card's name and
power limit, one JSON object of per-kernel numbers, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PHASES = ("identity", "build", "kernels", "timing", "main", "states",
          "profile", "cli")


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


def compare(name, got, want, mode):
    """mode: 'equal' | 'rtol1e-6' | 'bf16ulp'. Returns the max abs error."""
    import torch
    torch.cuda.synchronize()
    require(got.shape == want.shape and got.dtype == want.dtype,
            "%s: shape/dtype %s %s vs %s %s" % (name, tuple(got.shape),
                                                got.dtype, tuple(want.shape),
                                                want.dtype))
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if mode == "equal":
        ok = torch.equal(got, want)
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
def plain_kernels():
    """Swap every kernel wrapper of the path for its plain version (the
    model and predict call them through their modules)."""
    from real_time_helmet_detection_tpu_torch.ops import (epilogue, peak,
                                                          residual)
    saved = (epilogue.bn_act, residual.bn_add_act, peak.peak_scores)
    epilogue.bn_act = epilogue.bn_act_reference
    residual.bn_add_act = residual.bn_add_act_reference
    peak.peak_scores = peak.peak_scores_reference
    try:
        yield
    finally:
        epilogue.bn_act, residual.bn_add_act, peak.peak_scores = saved


@contextlib.contextmanager
def site_bytes(totals):
    """Add up, per wrapper, the bytes each call must move (inputs read
    once, output written once) while the block runs."""
    from real_time_helmet_detection_tpu_torch.ops import epilogue, residual
    saved = (epilogue.bn_act, residual.bn_add_act)

    def bn_act(x, *args):
        totals["bn_act"] = totals.get("bn_act", 0) \
            + 2 * x.numel() * x.element_size()
        return saved[0](x, *args)

    def bn_add_act(y, *args):
        totals["bn_add_act"] = totals.get("bn_add_act", 0) \
            + 3 * y.numel() * y.element_size()
        return saved[1](y, *args)
    epilogue.bn_act, residual.bn_add_act = bn_act, bn_add_act
    try:
        yield totals
    finally:
        epilogue.bn_act, residual.bn_add_act = saved


def reset_counts():
    from real_time_helmet_detection_tpu_torch.ops import (epilogue, peak,
                                                          residual)
    epilogue.launches = residual.launches = peak.launches = 0


def read_counts():
    from real_time_helmet_detection_tpu_torch.ops import (epilogue, peak,
                                                          residual)
    return {"bn_act": epilogue.launches, "bn_add_act": residual.launches,
            "peak_scores": peak.launches}


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


def phase_kernels(state):
    import torch
    from real_time_helmet_detection_tpu_torch.ops import (epilogue, peak,
                                                          residual)
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = state.setdefault("errs", {})
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for act in ("ReLU", "Linear", "Mish"):
            mode = ("equal" if act != "Mish" else
                    "rtol1e-6" if dtype == torch.float32 else "bf16ulp")
            for shape in EPI_SHAPES:
                x = channels_last(rand(shape, dtype, gen, 2.0))
                a = rand((shape[1],), torch.float32, gen, 0.5) + 1.0
                b = rand((shape[1],), torch.float32, gen, 0.5)
                err = compare("bn_act %s %s %s" % (tag, act, shape),
                              epilogue.bn_act(x, a, b, act),
                              epilogue.bn_act_reference(x, a, b, act), mode)
                errs[("bn_act", tag, act, shape)] = err
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
                 + 30.0)):
            err = compare("peak_scores pool %d %s" % (pool_size, label),
                          peak.peak_scores(logits, 2, pool_size),
                          peak.peak_scores_reference(logits, 2, pool_size),
                          "equal")
            errs[("peak_scores", pool_size, label)] = err
            n += 1
    log("kernels: %d comparisons against the plain versions passed "
        "(max abs err: bn_act Mish f32 %g, bf16 %g; bn_add_act Mish f32 "
        "%g, bf16 %g; all others 0)"
        % (n, max(v for k, v in errs.items() if k[:3] == ("bn_act", "f32",
                                                            "Mish")),
           max(v for k, v in errs.items() if k[:3] == ("bn_act", "bf16",
                                                       "Mish")),
           max(v for k, v in errs.items() if k[:3] == ("bn_add_act", "f32",
                                                       "Mish")),
           max(v for k, v in errs.items() if k[:3] == ("bn_add_act", "bf16",
                                                       "Mish"))))
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
    for pool_size in (3, 5):
        rows[("peak_scores", "f32", pool_size)] = dict(
            ms=graph_ms(lambda: peak.peak_scores(logits, 2, pool_size)),
            eager_ms=eager_ms(lambda: peak.peak_scores(logits, 2, pool_size)),
            plain_ms=graph_ms(
                lambda: peak.peak_scores_reference(logits, 2, pool_size)),
            library_ms=None, bound_ms=pbytes / HBM_BYTES_PER_S * 1e3,
            shape=PEAK_SHAPE)
    for key, r in rows.items():
        log("  %-36s kernel %.4f (eager %.4f)  plain %.4f  library %s  "
            "bound %.4f  at %s" % (
                "%s %s %s" % key, r["ms"], r["eager_ms"], r["plain_ms"],
                "%.4f" % r["library_ms"] if r["library_ms"] is not None
                else "none", r["bound_ms"], r["shape"]))


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
    want = {"bn_act": 20, "bn_add_act": 17, "peak_scores": 1}
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


def phase_profile(state):
    """Where the device time of one flagship predict goes, from a
    torch.profiler trace (CUDA activity only) of 3 predicts: our kernels,
    convolutions, the rest. The device's idle share is 1 - busy / wall,
    with wall the median ms per predict of phase main, taken without the
    profiler: the profiler's own host overhead stretches the traced
    predicts' wall, which it reports beside."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state
    from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
    require("main" in state, "phase profile reads phase main's predict "
            "times: run both")
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
        torch.cuda.synchronize()
        reps = 3
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                predict(images)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3 / reps
        by_name = {}
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.key] = by_name.get(ev.key, 0.0) \
                    + ev.self_device_time_total / 1e3 / reps
        busy = sum(by_name.values())
        if busy == 0.0:
            log("profile %s: the profiler saw no device time; breakdown "
                "not measured (traced wall %.2f ms per predict)"
                % (tag, traced_ms))
            continue
        groups = {"bn_act kernel": 0.0, "bn_add_act kernel": 0.0,
                  "peak kernel": 0.0, "convolution": 0.0, "copies": 0.0,
                  "other": 0.0}
        # cuDNN's convolution kernels: implicit GEMMs, FFT and Winograd
        # algorithms and their layout transforms
        conv_keys = ("conv", "xmma", "cudnn", "gemm", "cutlass", "fft",
                     "winograd", "pointwise_mult_and_sum_complex")
        for name, ms in by_name.items():
            low = name.lower()
            if "bn_add_act_kernel" in name:
                groups["bn_add_act kernel"] += ms
            elif "bn_act_kernel" in name:
                groups["bn_act kernel"] += ms
            elif "peak_kernel" in name:
                groups["peak kernel"] += ms
            elif any(k in low for k in conv_keys):
                groups["convolution"] += ms
            elif low.startswith("memcpy") or low.startswith("memset"):
                groups["copies"] += ms
            else:
                groups["other"] += ms
        state.setdefault("profile", {})[tag] = dict(
            wall_ms=wall_ms, traced_ms=traced_ms, busy_ms=busy,
            groups=groups)
        log("profile %s (ms per predict of 16 x 512^2): wall %.2f (phase "
            "main, untraced; %.2f under the profiler), device busy %.2f, "
            "idle share %.1f%%; %s" % (
                tag, wall_ms, traced_ms, busy,
                100.0 * max(0.0, 1 - busy / wall_ms),
                ", ".join("%s %.2f (%.1f%%)" % (k, v, 100 * v / busy)
                          for k, v in groups.items())))
        log("    bound over the forward's sites (bytes / 3.35 TB/s): "
            "bn_act %.3f ms, bn_add_act %.3f ms"
            % tuple(nbytes[k] / HBM_BYTES_PER_S * 1e3
                    for k in ("bn_act", "bn_add_act")))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        for name, ms in top:
            log("    %8.3f ms  %s" % (ms, name[:110]))
        del predict
        torch.cuda.empty_cache()


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
    errs, timing = state["errs"], state["timing"]
    launches = state["launches"]["bf16"]
    src = "real_time_helmet_detection_tpu_torch/csrc/%s.cu"
    spec = [
        ("peak_scores", "peak", "real_time_helmet_detection_tpu/ops/pallas/"
         "peak.py:68", ("peak_scores", "f32", 3),
         ("peak_scores", 3, "normal")),
        ("bn_act", "epilogue", "real_time_helmet_detection_tpu/ops/pallas/"
         "epilogue.py:138", ("bn_act", "bf16", "ReLU"),
         ("bn_act", "bf16", "ReLU", (16, 128, 256, 256))),
        ("bn_add_act", "residual", "real_time_helmet_detection_tpu/ops/"
         "pallas/residual.py:91", ("bn_add_act", "bf16", "ReLU"),
         ("bn_add_act", "bf16", "ReLU", (16, 128, 256, 256))),
    ]
    rows = []
    for name, cu, replaces, tkey, ekey in spec:
        t = timing[tkey]
        rows.append({"name": name, "route": "cuda", "source": src % cu,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[ekey], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": "bytes", "library_ms": t["library_ms"]})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %s (default: all)"
                    % ",".join(PHASES))
    phases = ap.parse_args(argv).phases.split(",")
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
