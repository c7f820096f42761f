"""Export of the predict program: `torch.export` per batch shape and, on
CUDA, an AOTInductor package that a C++ runner with no Python runs.

Port of ref real_time_helmet_detection_tpu/export.py:38
`build_export_fn`, :60 `export_predict` and :230 `load_exported`
(reference export.py: the TorchScript trace a C++ libtorch app runs).
The program is `make_predict_fn`'s body (network, peak test, top-k, NMS,
with fixed shapes and a `valid` mask) as a module that returns
`(boxes, classes, scores, valid)`, traced under `torch.no_grad()`. An
export directory holds:

* `exported_predict.pt2`: `torch.export.save` of the program, with the
  weights (Python consumers: `load_exported`);
* `exported_predict.aoti.pt2`, on CUDA only: the program compiled by
  `torch._inductor.aoti_compile_and_package`, which
  `cpp/runner.cc` runs (the counterpart of the JAX package's
  `.stablehlo.mlir` and its PJRT runner). An export on the CPU writes
  none, and its meta.json says so (`runner_package` null);
* `meta.json`: every key of the JAX package's (export.py:199-232), plus
  `torch_version`, `device`, `program`, `runner_package`, the digests of
  the kernel libraries and of the op library the program calls
  (`kernel_libraries`, `op_library`; the runner refuses others) and the
  seconds the export and the compile took;
* `calibration/quant_scales.json` with `--infer-dtype int8`: the
  activation scales the program bakes in (`--quant-scales`, or a
  calibration on synthetic batches), their sha256 in meta.json, the same
  hash as the JAX package's `scales_hash` of the same scales;
* `serving/b<N>/` with `--export-serve`: for each bucket of
  `serving.resolve_buckets(cfg)`, a self-contained directory (program,
  package, meta.json) at that batch.

The JAX package forces its Pallas kernels off at export (export.py:80),
so that its StableHLO does not pin a libtpu. The port's program keeps
its kernels: the graph calls the `helmet` operators (`ops.library`),
which the runner resolves from the op library (csrc/torch_ops.cpp) and
which launch the same hand-written kernels. `--export-raw-input` bakes
the uint8 wire and the normalization into the program, as the JAX
package does. Every file is written atomically (a temporary file, then
`os.replace`).
"""

from __future__ import annotations

import io
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence, Tuple

import torch

from .config import Config
from .ops import _build
from .predict import make_predict_fn, resolve_device
from .utils import atomic_write_bytes, save_json

PROGRAM = "exported_predict.pt2"
RUNNER_PACKAGE = "exported_predict.aoti.pt2"
OUTPUTS = ["boxes[B,N,4]", "classes[B,N]", "scores[B,N]", "valid[B,N]"]


class PredictProgram(torch.nn.Module):
    """A predict's body as a module: images -> (boxes, classes, scores,
    valid). The model (float, or the int8 twin) is a submodule, so its
    weights are the program's parameters and buffers."""

    def __init__(self, predict):
        super().__init__()
        self.model = predict.model
        self._body = predict.body

    def forward(self, images: torch.Tensor):
        d = self._body(images)
        return d.boxes, d.classes, d.scores, d.valid


def build_export_fn(model: torch.nn.Module, cfg: Config,
                    normalize: Optional[str] = None, quant_scales=None,
                    device="cuda") -> PredictProgram:
    """The predict program of `model` on `device` (ref export.py:38):
    `normalize` bakes the input normalization in (raw [0, 255] pixels
    in); `quant_scales` (with `cfg.infer_dtype == "int8"`) bakes in the
    folded int8 twin."""
    return PredictProgram(make_predict_fn(model, cfg, normalize=normalize,
                                          device=device,
                                          quant_scales=quant_scales))


def trace(program: PredictProgram, batch: int, imsize: int,
          dtype: torch.dtype, device) -> torch.export.ExportedProgram:
    """`torch.export` of the program at one batch shape, grad off."""
    example = torch.zeros((batch, imsize, imsize, 3), dtype=dtype,
                          device=device)
    with torch.no_grad():
        return torch.export.export(program, (example,))


def save_program(ep: torch.export.ExportedProgram, path: str) -> None:
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    atomic_write_bytes(path, buf.getvalue())


# Inductor settings that keep the code it generates around the kernels
# (normalization, decode, NMS) to eager's roundings: a low-precision
# result rounded where eager rounds it, and IEEE division (Triton's `/`
# is approximate); each set where the installed torch has it (the names
# moved between releases)
EAGER_NUMERICS = ("emulate_precision_casts", "emulate_divison_rounding",
                  "eager_numerics.division_rounding")


def _inductor_configs() -> dict:
    from torch._inductor import config

    def has(name):
        node = config
        for part in name.split("."):
            if not hasattr(node, part):
                return False
            node = getattr(node, part)
        return True

    configs = {name: True for name in EAGER_NUMERICS if has(name)}
    configs["cpp.cxx"] = (None, _build.CXX)
    return configs


def compile_package(ep: torch.export.ExportedProgram, path: str) -> float:
    """The AOTInductor package of `ep` at `path`, written whole or not at
    all; returns the compile's seconds. Its generated code keeps eager's
    roundings (`EAGER_NUMERICS`), and its C++ is compiled by the compiler
    that builds the op library and the runner (`_build.CXX`), not by
    `$CXX`."""
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".pt2", dir=os.path.dirname(path))
    os.close(fd)
    t0 = time.perf_counter()
    try:
        torch._inductor.aoti_compile_and_package(
            ep, package_path=tmp, inductor_configs=_inductor_configs())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return time.perf_counter() - t0


def export_predict(cfg: Config, out_dir: Optional[str] = None,
                   batch_size: int = 1,
                   model: Optional[torch.nn.Module] = None,
                   runner_batches: Optional[Sequence[int]] = None
                   ) -> Tuple[str, Optional[str]]:
    """Export the predict program for `cfg` (ref export.py:60) into
    `out_dir` (default `cfg.save_path`) at `batch_size`, on `cfg.device`
    (CUDA unless `--device cpu`; CUDA raises without a card). Weights
    are `model`'s, else `cfg.model_load`'s, else seeded from
    `cfg.random_seed`. On CUDA each program also gets its AOTInductor
    package, for the batches in `runner_batches` (default: every one).

    Returns (program path, runner package path or None)."""
    from .evaluate import load_eval_state
    from .ops import quant

    dev = resolve_device(cfg.device)
    out_dir = out_dir or cfg.save_path
    os.makedirs(out_dir, exist_ok=True)
    imsize = cfg.imsize or 512
    if model is None:
        model = load_eval_state(cfg, device=dev)
    normalize = cfg.pretrained if cfg.export_raw_input else None
    in_dtype = torch.uint8 if cfg.export_raw_input else torch.float32

    quant_scales, scales_sha, scales_rel = None, None, None
    if cfg.infer_dtype == "int8":
        if cfg.quant_scales:
            quant_scales = quant.load_scales(cfg.quant_scales)
        else:
            print("warning: --infer-dtype int8 export without "
                  "--quant-scales; calibrating on synthetic batches "
                  "(smoke-quality scales: pass the eval-produced artifact "
                  "for a served deployment)")
            quant_scales = quant.calibrate_scales(
                cfg, model.state_dict(), quant.synthetic_calibration_batches(
                    batch_size, imsize, n=cfg.calib_batches,
                    raw=cfg.export_raw_input),
                dtype=model.dtype, normalize=normalize,
                percentile=cfg.calib_percentile, device=dev)
        scales_path = os.path.join(out_dir, "calibration",
                                   "quant_scales.json")
        scales_sha = quant.save_scales(scales_path, quant_scales, meta={
            "source": cfg.quant_scales or "synthetic",
            "calib_percentile": cfg.calib_percentile})
        scales_rel = os.path.relpath(scales_path, out_dir)

    program = build_export_fn(model, cfg, normalize=normalize,
                              quant_scales=quant_scales, device=dev)
    common = {
        "input_dtype": "uint8" if cfg.export_raw_input else "float32",
        "num_boxes": cfg.num_stack * cfg.topk,
        "imsize": imsize, "num_cls": cfg.num_cls,
        "raw_input": bool(cfg.export_raw_input),
        "infer_dtype": cfg.infer_dtype,
        "torch_version": torch.__version__, "device": dev.type,
        "program": PROGRAM,
        "kernel_libraries": _build.kernel_digests(),
        "op_library": _build.ops_digest(),
    }

    def write(directory: str, batch: int) -> dict:
        """Export at `batch` into `directory`: the program, and on CUDA
        its package; returns the meta.json keys it sets."""
        t0 = time.perf_counter()
        ep = trace(program, batch, imsize, in_dtype, dev)
        save_program(ep, os.path.join(directory, PROGRAM))
        rec = {"input_shape": [batch, imsize, imsize, 3],
               "export_s": time.perf_counter() - t0,
               "runner_package": None, "aoti_compile_s": None}
        if dev.type == "cuda" and (runner_batches is None
                                   or batch in runner_batches):
            rec["aoti_compile_s"] = compile_package(
                ep, os.path.join(directory, RUNNER_PACKAGE))
            rec["runner_package"] = RUNNER_PACKAGE
        return rec

    primary = write(out_dir, batch_size)

    serve_buckets, serve_rel = [], {}
    if cfg.export_serve:
        from .serving import resolve_buckets
        serve_buckets = list(resolve_buckets(cfg))
        for b in serve_buckets:
            bdir = os.path.join(out_dir, "serving", "b%d" % b)
            os.makedirs(bdir, exist_ok=True)
            if b == batch_size:  # the primary program at that batch
                for name in (PROGRAM, primary["runner_package"]):
                    if name:
                        shutil.copyfile(os.path.join(out_dir, name),
                                        os.path.join(bdir, name))
                rec = dict(primary)
            else:
                rec = write(bdir, b)
            save_json(os.path.join(bdir, "meta.json"),
                      {**common, **rec, "serve_bucket": b}, indent=2)
            serve_rel["b%d" % b] = os.path.relpath(bdir, out_dir)

    save_json(os.path.join(out_dir, "meta.json"), {
        **common, **primary,
        "outputs": OUTPUTS,
        "conf_th": cfg.conf_th,
        "nms": cfg.nms,
        "nms_th": cfg.nms_th,
        "pretrained": cfg.pretrained,
        "quant_scales_sha256": scales_sha,
        "quant_scales_path": scales_rel,
        "serve_buckets": serve_buckets,
        "serve_artifacts": serve_rel,
    }, indent=2)
    package = primary["runner_package"]
    return (os.path.join(out_dir, PROGRAM),
            os.path.join(out_dir, package) if package else None)


def load_exported(path: str):
    """A saved program back as a callable (ref export.py:230):
    `fn(images) -> (boxes, classes, scores, valid)`, run under
    `torch.inference_mode()` on the device its weights were exported
    on. The `helmet` ops resolve to this process's registration
    (`ops.library`, imported with `ops`)."""
    module = torch.export.load(path).module()

    def call(images: torch.Tensor):
        with torch.inference_mode():
            return tuple(module(images))

    return call

