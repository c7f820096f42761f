"""The counting model and the served latency of a tier's b1 predict at
the preset's real width (ref scripts/quality_matrix.py:269-331
`predict_stats`).

JAX reads its counts from XLA's compiled program (scripts/roofline.py
`parse_hlo` / `attribute` and `cost_analysis()`); the port has no such
program, so it counts for itself and labels the result
"count": "port-analytic", never to be read as XLA's per-op-class count:

* FLOPs: the roofline count (`obs.roofline.count_rows`) of the plain
  forward on `meta` tensors, its exact rows (the convolutions; decode
  and NMS count nothing), `conv_flops` = 2 * sum of k^2 * c_in / groups
  * c_out * H * W over the convolution rows;
* bytes, once each at the serving dtypes (bf16 activations and conv
  weights, float32 for the other parameters and buffers, the uint8
  image): `predict_bytes` is the state, the input and the output of
  every row of `models.hourglass.layer_summary`; `conv_bytes` each
  convolution row's weight, input and output at those dtypes (the
  count's own bytes are the f32 forward's);
* `serve_wire_ms_b1` / `serve_wire_p99_ms_b1`: nearest-rank p50 and p99,
  submit to result, of a serial stream of uint8 images through a
  `ServingEngine` with bucket 1 (a CUDA graph replay on the card),
  after a warm-up; JAX times a donating predict chain instead
  (`bench.chain_timed_fetch`). Seeded weights: neither count nor
  latency depends on them."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from ..config import Config, TIER_PRESETS
from ..models.hourglass import build_model, layer_summary

ACT_BYTES = 2      # bf16 activations and conv weights on the serving path
PARAM_BYTES = 4    # BN parameters and running statistics (float32)


def preset_config(name: str, imsize: int, device: str = "cuda") -> Config:
    """The tier's serving configuration at its real width: bf16 (--amp),
    the preset's architecture, hard NMS as JAX's predict_stats has it."""
    p = TIER_PRESETS[name]
    return Config(device=device, variant=p["variant"],
                  num_stack=p["num_stack"], hourglass_inch=p["hourglass_inch"],
                  stem_width=p.get("stem_width", 0), num_cls=2, topk=100,
                  conf_th=0.0, nms_th=0.5, imsize=imsize, amp=True)


def _pctl(sorted_vals: List[float], q: float) -> float:
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(round(q * (len(sorted_vals) - 1))))]


def _numel(shape) -> int:
    return int(np.prod(shape)) if shape else 1


def conv_bytes(row: Dict) -> int:
    """A convolution row's bytes at the serving dtypes: its input, weight
    and output at ACT_BYTES an element, its bias (if any) at PARAM_BYTES,
    once per call."""
    (x, _), (w, _) = row["operands"][:2]
    per = ACT_BYTES * (_numel(x) + _numel(w) + _numel(row["results"][0][0]))
    if len(row["operands"]) > 2:
        per += PARAM_BYTES * _numel(row["operands"][2][0])
    return row["calls"] * per


def counts(cfg: Config, imsize: int) -> Dict:
    """FLOPs and bytes of one b1 predict of `cfg` at `imsize` (see the
    module docstring); no tensor lives on a device."""
    from ..obs.roofline import count_rows
    with torch.device("meta"):
        model = build_model(cfg).eval()
    image = torch.empty(1, imsize, imsize, 3, device="meta")

    def forward():
        with torch.no_grad():
            model(image)
    rows, _ = count_rows(forward)
    convs = [r for r in rows if r["opcode"] == "convolution"]
    weights = {id(m.weight) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)}
    state = sum(t.numel() * (ACT_BYTES if id(t) in weights else PARAM_BYTES)
                for t in list(model.parameters()) + list(model.buffers())
                if t.is_floating_point())
    summary, n_params = layer_summary(cfg, imsize)
    outputs = sum(int(np.prod(shape)) for _, _, shape, _ in summary if shape)
    return {"count": "port-analytic",
            "predict_gflops": round(sum(r["flops"] for r in rows
                                        if not r["approx"]) / 1e9, 3),
            "conv_flops": int(sum(r["flops"] for r in convs)),
            "predict_bytes": int(state + imsize * imsize * 3
                                 + ACT_BYTES * outputs),
            "conv_bytes": sum(conv_bytes(r) for r in convs),
            "params_m": round(n_params / 1e6, 4)}


def serve_latency_ms(cfg: Config, imsize: int, requests: int,
                     warmup: int = 3, seed: int = 0) -> Dict:
    """p50 / p99 ms of a serial stream of `requests` uint8 images through a
    bucket-1 `ServingEngine` of `cfg`'s bf16 predict on `cfg.device`."""
    from ..evaluate import init_weights
    from ..models.hourglass import cast_convs
    from ..obs.metrics import MetricsRegistry
    from ..obs.spans import SpanTracer
    from ..predict import make_predict_fn, resolve_device
    from ..serving import ServingEngine
    dev = resolve_device(cfg.device)
    model = init_weights(build_model(cfg, dtype=torch.bfloat16), seed)
    model = model.to(dev).eval()
    cast_convs(model, torch.bfloat16)
    predict = make_predict_fn(model, cfg, normalize="imagenet", device=dev)
    rng = np.random.default_rng(seed)
    pool = [rng.integers(0, 256, (imsize, imsize, 3), dtype=np.uint8)
            for _ in range(4)]
    lats = []
    with ServingEngine(predict, None, (imsize, imsize, 3), np.uint8,
                       buckets=(1,), max_wait_ms=0.0,
                       tracer=SpanTracer(None),
                       metrics=MetricsRegistry()) as engine:
        for i in range(warmup + requests):
            t0 = time.perf_counter()
            engine.submit(pool[i % len(pool)]).result()
            if i >= warmup:
                lats.append((time.perf_counter() - t0) * 1e3)
    lats.sort()
    return {"serve_wire_ms_b1": round(_pctl(lats, 0.50), 3),
            "serve_wire_p99_ms_b1": round(_pctl(lats, 0.99), 3),
            "serve_wire_requests": requests}


def predict_stats(name: str, imsize: int, device: str,
                  requests: int) -> Dict:
    """The tier row's counting model and served latency (JAX's
    `predict_stats` keys, plus "count", the p99 and the request count)."""
    cfg = preset_config(name, imsize, device)
    out = counts(cfg, imsize)
    out.update(serve_latency_ms(cfg, imsize, requests))
    return out
