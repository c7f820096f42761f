"""Where the train step's time goes on the card, by component: the port
of ref scripts/mfu_breakdown.py:1-42 (`main` :97, `analytic_rec` :175,
the `measure(...)` list).

Each component of the flagship (1 stack, width 128, bf16 activations)
at b16 512^2 is timed on the card and counted by the roofline count
(`obs.roofline.count_rows`, on `meta` tensors: the same FLOPs and bytes
whatever implements the work):

  train_step, train_step_stem_s2d (the `--amp` step of
  `train.make_train_step`, Adam; `--stem-s2d`), forward (the eval
  network), forward_backward (train-mode forward, the fused loss,
  backward; no update), stem_fwd, hourglass_fwd, neck_fwd, head_fwd
  (eval modules on the stem's or the stack's input), loss (the fused
  loss's forward, #12), and JAX's calibration entries
  conv3x3_128ch_128sq, conv7x7s2_3to64, conv7x7s2_s2d,
  batchnorm_128sq (the train BN kernels #4 + #5, forward) and
  upsample2x_64sq.

Timing (`timing` in each record): CUDA events over CUDA graph replays
("graph") for the forward-only components; CUDA events over eager
iterations ("eager") for the three with a backward: a replayed step
would repeat its host-side optimizer count and accumulate into the
gradients, so it cannot be captured as it runs. Each record holds `ms`,
`gflops`, `gbytes`, JAX's `t_mxu_ms` / `t_hbm_ms` / `t_roofline_ms` /
`roofline_mfu` / `binds` at the card's constants, `mfu` and `hbm_util`.

`--analytic` (JAX's compile-only mode): the counts alone at the
flagship's shapes on `meta`, no card, nothing executed.
`--device cpu`: 64^2 batch 2 (JAX's off-chip shapes), host-clock times
(`timing` "host"), no device metric.

    python -m real_time_helmet_detection_tpu_torch.obs.breakdown \\
        [--analytic] [--device cpu] [--out F.json]

Writes artifacts/<round>/mfu_breakdown.json (mfu_roofline_analytic.json
with --analytic) and prints the JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Tuple

import torch

from . import roofline
from ..utils import save_json

# component -> True when its run has a backward (timed eagerly)
COMPONENTS = {
    "train_step": True, "forward": False, "forward_backward": True,
    "stem_fwd": False, "hourglass_fwd": False, "neck_fwd": False,
    "head_fwd": False, "loss": False, "conv3x3_128ch_128sq": False,
    "conv7x7s2_3to64": False, "conv7x7s2_s2d": False,
    "train_step_stem_s2d": True, "batchnorm_128sq": False,
    "upsample2x_64sq": False,
}


def _eval_module(module: torch.nn.Module, device: str) -> torch.nn.Module:
    """An eval-mode submodule on `device`, its convs in bf16 as the
    served predict holds them, seeded weights off `meta`."""
    from ..evaluate import init_weights
    from ..models.hourglass import cast_convs
    if device != "meta":
        module = init_weights(module, 0)
    return cast_convs(module.to(device).eval(), torch.bfloat16)


def _nchw(shape, device: str, dtype=torch.bfloat16) -> torch.Tensor:
    """A seeded channels-last (N, C, H, W) tensor (empty on `meta`)."""
    if device == "meta":
        t = torch.empty(shape, dtype=dtype, device="meta")
    else:
        g = torch.Generator().manual_seed(0)
        t = torch.randn(shape, generator=g).to(device=device, dtype=dtype)
    return t.contiguous(memory_format=torch.channels_last)


def build(name: str, device: str, imsize: int, batch: int
          ) -> Callable[[], object]:
    """Component `name`'s run on `device` (module docstring)."""
    import torch.nn.functional as F
    from ..models.hourglass import (Head, Hourglass, Neck, PreLayer,
                                    stem_s2d_conv)
    from ..ops.epilogue import bn_act_train
    from ..ops.loss import fused_detection_loss
    from ..train import loss_fn
    args = roofline.build_parser().parse_args([
        "--batch", str(batch), "--imsize", str(imsize)])
    args.device = device
    m = imsize // 4
    feat = (batch, 128, m, m)
    if name in ("train_step", "train_step_stem_s2d"):
        if name == "train_step":
            return roofline.build_step(args, device)
        return roofline.build_step(args, device, stem_s2d=True)
    if name in ("forward", "forward_backward"):
        from ..evaluate import init_weights
        from ..models.hourglass import build_model, cast_convs
        cfg = roofline._config(args, train=True)
        with torch.device("meta" if device == "meta" else "cpu"):
            model = build_model(cfg, dtype=torch.bfloat16)
        if device != "meta":
            model = init_weights(model, 0)
        images, heat, off, wh, mask = roofline.train_arrays(args, device)
        if name == "forward":
            model = cast_convs(model.to(device).eval(), torch.bfloat16)

            def forward():
                with torch.no_grad():
                    return model(images)
            return forward
        model = model.to(device).train()

        def forward_backward():
            model.zero_grad(set_to_none=True)
            loss_fn(model, images, heat, off, wh, mask, cfg)[0].backward()
        return forward_backward
    images = _nchw((batch, 3, imsize, imsize), device)
    x = _nchw(feat, device)
    if name == "loss":
        _, heat, off, wh, mask = roofline.train_arrays(args, device)
        out = torch.zeros((batch, 1, m, m, 6), device=device)

        def loss():
            with torch.no_grad():
                return fused_detection_loss(out, heat, off, wh,
                                            mask)["total"]
        return loss
    if name == "batchnorm_128sq":
        gamma = torch.ones(128, device=device)
        beta = torch.zeros(128, device=device)

        def batchnorm():
            with torch.no_grad():
                return bn_act_train(x, gamma, beta, "Linear")[0]
        return batchnorm
    if name == "upsample2x_64sq":
        half = x[:, :, ::2, ::2].contiguous(memory_format=torch.channels_last)
        return lambda: F.interpolate(half, scale_factor=2, mode="nearest")
    modules = {
        "stem_fwd": (lambda: PreLayer(128, 128), images),
        "hourglass_fwd": (lambda: Hourglass(4, 128), x),
        "neck_fwd": (lambda: Neck(128), x),
        "head_fwd": (lambda: Head(128, 6), x),
        "conv3x3_128ch_128sq": (
            lambda: torch.nn.Conv2d(128, 128, 3, padding=1, bias=False), x),
        "conv7x7s2_3to64": (
            lambda: torch.nn.Conv2d(3, 64, 7, 2, 3), images),
        "conv7x7s2_s2d": (lambda: torch.nn.Conv2d(3, 64, 7, 2, 3), images),
    }
    make, inp = modules[name]
    with torch.device("meta" if device == "meta" else "cpu"):
        module = make()
    module = _eval_module(module, device)
    if isinstance(module, torch.nn.Conv2d):
        module = module.to(memory_format=torch.channels_last)
        if name == "conv7x7s2_s2d":
            return lambda: stem_s2d_conv(inp, module)

    def run():
        with torch.no_grad():
            return module(inp)
    return run


def analytic_rec(fl: float, by: float, const: Dict[str, float]) -> Dict:
    """The roofline record of FLOPs and bytes alone (ref
    mfu_breakdown.py:175), at the card's bf16 peak and bandwidth."""
    peak, hbm = const["bf16"], const["hbm_bytes_per_s"]
    rec = {}
    if fl:
        rec["gflops"] = round(fl / 1e9, 2)
        rec["t_mxu_ms"] = round(fl / peak * 1e3, 4)
    if by:
        rec["gbytes"] = round(by / 1e9, 3)
        rec["t_hbm_ms"] = round(by / hbm * 1e3, 4)
    if fl and by:
        t_min = max(fl / peak, by / hbm)
        rec["t_roofline_ms"] = round(t_min * 1e3, 4)
        rec["roofline_mfu"] = round(fl / peak / t_min, 4)
        rec["binds"] = "hbm" if by / hbm > fl / peak else "mxu"
    return rec


def graph_ms(fn: Callable[[], object], calls: int = 3,
             replays: int = 2) -> float:
    """Device ms of one fn() call: `calls` calls captured in one CUDA
    graph, `replays` replays between CUDA events (after warm-up)."""
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
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def eager_ms(fn: Callable[[], object], iters: int = 3) -> float:
    """Stream ms of one fn() call issued eagerly (CUDA events around
    `iters` calls after 3 of warm-up)."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn: Callable[[], object], iters: int = 2) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def count_component(name: str, imsize: int, batch: int) -> Tuple[float,
                                                                 float]:
    """(FLOPs, bytes) of one call of component `name`, counted on
    `meta`."""
    rows, _ = roofline.count_rows(build(name, "meta", imsize, batch))
    return (sum(r["flops"] for r in rows), sum(r["bytes"] for r in rows))


def measure(name: str, device: str, imsize: int, batch: int,
            const: Dict[str, float], analytic: bool) -> Dict:
    """One component's record (module docstring)."""
    fl, by = count_component(name, imsize, batch)
    rec = analytic_rec(fl, by, const)
    if analytic:
        return rec
    run = build(name, device, imsize, batch)
    if device == "cpu":
        rec.update(ms=round(host_ms(run), 4), timing="host")
        return rec
    eager = COMPONENTS[name]
    ms = eager_ms(run) if eager else graph_ms(run)
    rec.update(ms=round(ms, 4), timing="eager" if eager else "graph",
               mfu=round(fl / (ms * 1e-3) / const["bf16"], 4),
               hbm_util=round(by / (ms * 1e-3) / const["hbm_bytes_per_s"],
                              4))
    return rec


def breakdown(device: str = "cuda", analytic: bool = False,
              names=tuple(COMPONENTS), log=None) -> Dict:
    """Every component's record at the flagship's shapes (64^2 batch 2
    timed on the CPU, as JAX's off-chip run)."""
    from ..predict import resolve_device
    if analytic:
        kind, card, dev = "meta", roofline.TARGET_CARD, None
    else:
        dev = resolve_device(device)
        kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        card = kind if dev.type == "cuda" else roofline.TARGET_CARD
    const = roofline.card_constants(card)
    full = analytic or dev.type == "cuda"
    imsize, batch = (512, 16) if full else (64, 2)
    out = {"platform": "gpu" if dev is not None and dev.type == "cuda"
           else "cpu", "device_kind": kind, "constants_of": card,
           "card": roofline.card_line() if kind not in ("cpu", "meta")
           else None, "imsize": imsize, "batch": batch,
           "peak_flops": const["bf16"],
           "hbm_bytes_per_s": const["hbm_bytes_per_s"],
           "analytic": analytic, "components": {}}
    for name in names:
        rec = measure(name, "meta" if analytic else dev.type, imsize,
                      batch, const, analytic)
        out["components"][name] = rec
        if log:
            log("%-22s %s" % (name, json.dumps(rec)))
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(
        prog="python -m real_time_helmet_detection_tpu_torch.obs.breakdown",
        description=__doc__.splitlines()[0])
    ap.add_argument("--analytic", action="store_true",
                    help="counts alone at the flagship's shapes, on meta")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    out = breakdown(args.device, args.analytic, log=roofline.log)
    path = args.out or os.path.join(
        roofline.REPO, "artifacts",
        os.environ.get("GRAFT_ROUND") or roofline.ROUND,
        "mfu_roofline_analytic.json" if args.analytic
        else "mfu_breakdown.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_json(path, out, indent=1)
    roofline.log("wrote %s" % path)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    from ..runtime import run_as_job
    run_as_job(main)
