"""Per-op roofline attribution of the predict and the train step on the
card: the port of ref scripts/roofline.py:1-58 (`SCHEMA` :78, `op_class`
:128, `class_totals` :146, `classify` :364, `_markdown` :398,
`build_step` :425, `build_predict` :469, `loss_subprogram_cost` :503,
`substitute_epilogue_analytic` :556, `diff_rooflines` :622,
`_diff_markdown` :707, `run_diff` :744, `main` :778) and of the peak and
bandwidth tables of ref bench.py:65-78. JAX parses XLA's compiled
program; the port counts the ATen operations a path dispatches.

The count (`OpCount`, a TorchDispatchMode): one row per (operation,
tensor shapes, dtypes) of one predict or one train step, with its
`calls`, `flops`, `bytes` and `class`:

* bytes: every tensor operand read once and every tensor result written
  once (JAX's operand+result rule); views move nothing and are no rows;
* FLOPs: convolutions, their backward and matrix products by
  `torch.utils.flop_counter`'s formulas; any other operation 1 per
  output element (0 for pure data movement), labelled `approx` as JAX's
  elementwise estimate is;
* classes: JAX's OP_CLASSES; a cast (`_to_copy` or `copy_` across
  dtypes) is "convert", a pool "reduce-window", `mm`-like ops "dot";
* each hand-written kernel (#1-#16, `KERNELS`) is one row named after
  it, whatever runs it: the `helmet::*` ops reach the mode as one
  operation (`ops.library.KERNEL_OF` maps the convs' code-writing ops
  and the quantizer at two steps to their kernels' rows), the ctypes
  wrappers through `ops.marks`, and the plain
  versions' ATen operations on the CPU or `meta` never appear. A
  kernel's bytes are its own transfers (`kernel_bytes`: the tensors of
  3 or more dimensions it reads and writes, the peak test's heat
  channels), which at a BN site add up to JAX's `site_kernel_bytes`
  (ref epilogue.py:84, residual.py:78: 8 / 2 and 12 / 3
  activation-sized transfers a train / eval site).

The count reads shapes only, so it runs on `meta` tensors at full size
with no card (`--no-trace`, `--device cpu`) and gives the same rows as
on the card; it does not move when a kernel's implementation changes.

The timing (`trace_rows`): a torch.profiler run (CPU and CUDA activity,
shapes recorded) of N >= 3 runs with the count labelling each counted
call (`record_function`). Each device operation joins the row of the
label around the CPU runtime call that launched it (their correlation
id), a hand kernel by its name where no label holds its launch; what
joins none is the row `unattributed`. The untraced wall is timed apart
(`untraced_ms`).

`classify` adds each row's intensity, its bound ("tensor" or "hbm")
against the ridge of its compute dtype's peak, `t_roofline_us =
max(flops / peak, bytes / bandwidth)`, its time, shares and
`l2_resident_possible` (its bytes per call fit twice over in the L2, or
its operands per call fit in it: such a row can beat its HBM bound).
The summary adds device busy (the union of the device operations'
ranges), the wall, the idle share and `mfu` = FLOPs / wall / peak.

    python -m real_time_helmet_detection_tpu_torch.obs.roofline \\
        [--mode train|predict] [--batch 16] [--imsize 512] [--no-trace] \\
        [--ab-loss-kernel] [--device cpu] [--out F.json] [--tag T]
    python -m real_time_helmet_detection_tpu_torch.obs.roofline \\
        --diff BASELINE.json CANDIDATE.json

It writes JSON (schema "roofline-v1", JAX's keys) and markdown beside,
by default to artifacts/<round>/roofline/ ($GRAFT_ROUND, default
`ROUND`), and prints one JSON line without the table. `--diff` joins two
roofline-v1 artifacts (JAX's committed ones too) with no device.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops import marks
from ..ops.library import KERNEL_OF
from ..utils import atomic_write_bytes, save_json

SCHEMA = "roofline-v1"
DIFF_SCHEMA = "roofline-diff-v1"
ROUND = "torch"  # artifacts/<round>/ when $GRAFT_ROUND is unset
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the card's constants: NVIDIA's data sheet (SXM part, dense rates
# without sparsity, at the 700 W limit); a card not listed raises
CARDS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16": 989.4e12, "tf32": 494.7e12, "fp32": 67.0e12,
        "int8": 1979.0e12, "hbm_bytes_per_s": 3.35e12, "l2_bytes": 50e6},
}
# what a count off the card (`--device cpu`) is classified against
TARGET_CARD = "NVIDIA H100 80GB HBM3"


def card_constants(name: str) -> Dict[str, float]:
    """The roofline constants of the card `name`
    (`torch.cuda.get_device_name()`); an unlisted card raises."""
    if name not in CARDS:
        raise ValueError("no roofline constants for the card %r (listed: "
                         "%s): add its data sheet's rates to CARDS"
                         % (name, ", ".join(CARDS)))
    return CARDS[name]


# the op-class taxonomy of ref roofline.py:125; order matters
# ("conv" is a prefix of both "convolution" and "convert")
OP_CLASSES = ("conv", "convert", "reduce-window", "dot", "elementwise")


def op_class(name: str, opcode: str) -> str:
    """Roofline op class of one row (ref roofline.py:128)."""
    n = name.lower()
    if opcode == "convolution" or "convolution" in n:
        return "conv"
    if opcode == "convert" or "convert" in n:
        return "convert"
    if opcode == "reduce-window" or "reduce-window" in n \
            or "reduce_window" in n:
        return "reduce-window"
    if opcode == "dot" or n.startswith("dot"):
        return "dot"
    return "elementwise"


def class_totals(rows) -> dict:
    """Per-class byte/FLOP rollup of a rows table (ref roofline.py:146;
    a row without 'class' takes op_class's)."""
    out = {c: {"bytes": 0.0, "flops": 0.0, "ops": 0} for c in OP_CLASSES}
    for r in rows:
        c = r.get("class") or op_class(r["name"], r["opcode"])
        out[c]["bytes"] += r["bytes"]
        out[c]["flops"] += r["flops"]
        out[c]["ops"] += 1
    total = sum(v["bytes"] for v in out.values()) or 1.0
    for v in out.values():
        v["pct_bytes"] = round(100.0 * v["bytes"] / total, 2)
    return out


# ------------------------------------------------------------- the count

# the hand-written kernels: row name -> (TPU kernel table number, class,
# approximate f32 operations per element of its first operand). The BN
# passes split JAX's ~20 (epilogue) and ~22 (residual) operations per
# element of a train site (ref roofline.py:596) over the port's passes;
# #12/#13 count per heat and per regression element of the output
# (LOSS_OPS); #14/#15 count exactly (`kernel_flops`)
KERNELS = {
    "peak_scores": ("1", "elementwise", 12),
    "bn_act": ("2/5", "elementwise", 3),
    "bn_eval_bwd": ("3", "elementwise", 8),
    "bn_stats": ("4", "elementwise", 2),
    "bn_bwd_sums": ("6", "elementwise", 7),
    "bn_bwd_dx": ("7", "elementwise", 8),
    "bn_add_act": ("8", "elementwise", 4),
    "bn_add_eval_bwd": ("9", "elementwise", 9),
    "bn_add_bwd_sums": ("10", "elementwise", 8),
    "bn_add_bwd_dx": ("11", "elementwise", 8),
    "loss_fwd": ("12", "elementwise", None),
    "loss_bwd": ("13", "elementwise", None),
    "qconv_dense": ("14", "conv", None),
    "qconv_dw": ("15", "conv", None),
    "quantize_act": ("16", "convert", 3),
    "abs_max": ("16", "elementwise", 1),
}
LOSS_OPS = {"loss_fwd": (20, 5), "loss_bwd": (31, 6)}  # (heat, regression)
# the device kernels of each row, for the join by name where a launch
# carries no label (substrings of the trace's kernel names)
KERNEL_NAMES = {
    "peak_scores": ("peak_kernel",), "bn_act": ("bn_act_vec_kernel",
                                                "bn_act_kernel"),
    "bn_add_act": ("bn_add_act_kernel",), "bn_stats": ("bn_stats_kernel",),
    "loss_fwd": ("loss_fwd_kernel",), "loss_bwd": ("loss_bwd",),
    "quantize_act": ("quantize_kernel",), "abs_max": ("absmax_kernel",),
    "qconv_dense": ("qconv_wgmma_kernel", "qconv_dense_kernel"),
    "qconv_dw": ("qconv_dw_tile_kernel", "qconv_dw_kernel"),
}
UNATTRIBUTED = "unattributed"
LABEL = "roofline:"

_CONV_OPS = ("convolution", "convolution_backward")
_DOT_OPS = ("mm", "addmm", "bmm", "baddbmm", "_int_mm", "addmv", "mv", "dot")
_WINDOW_OPS = ("max_pool2d_with_indices", "max_pool2d_with_indices_backward",
               "avg_pool2d", "avg_pool2d_backward", "max_pool2d")
_CASTS = ("_to_copy", "copy_")
# operations that move or make data and compute nothing (0 FLOPs)
_MOVES = ("clone", "copy_", "_to_copy", "cat", "stack", "zeros", "ones",
          "full", "empty", "empty_like", "empty_strided", "zeros_like",
          "ones_like", "full_like", "new_zeros", "new_ones", "new_full",
          "new_empty", "new_empty_strided", "fill_", "zero_",
          "constant_pad_nd", "index", "index_select", "gather", "scatter",
          "scatter_", "slice_scatter", "select_scatter", "repeat", "arange",
          "_local_scalar_dense", "upsample_nearest2d",
          "upsample_nearest2d_backward", "_unsafe_index", "flip", "roll",
          "tril", "triu", "_foreach_copy_")
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16", torch.float64: "f64", torch.int8: "s8",
           torch.uint8: "u8", torch.int32: "s32", torch.int64: "s64",
           torch.bool: "pred", torch.int16: "s16"}


def _tensors(x) -> List[torch.Tensor]:
    """The tensors of an argument or a result, lists and tuples flat."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _sig(x) -> Optional[str]:
    """One argument's part of a row's name: 'd0xd1:dtype' for a tensor,
    'n*dtype=numel' for a list of them, None for anything else."""
    if isinstance(x, torch.Tensor):
        return "%s:%s" % ("x".join(map(str, x.shape)),
                          _DTYPES.get(x.dtype, str(x.dtype)))
    ts = _tensors(x)
    if ts and isinstance(x, (list, tuple)):
        return "%d*%s=%d" % (len(ts), _DTYPES.get(ts[0].dtype, "?"),
                             sum(t.numel() for t in ts))
    return None


def _nbytes(ts: Sequence[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def written_in_place(name: str, args) -> float:
    """The bytes hand-written kernel `name` writes into tensors it was
    given (a `helmet::*_codes` op's `Tensor(a!)` arguments): an int8
    conv's code outputs (#14, #15), each only its Cout channels of the
    wider tensor it writes into."""
    if name in ("qconv_dense", "qconv_dw") and args:
        q = args[0]
        cout = args[1].shape[0] if name == "qconv_dense" else q.shape[1]
        codes = [t for t in args[4:] if isinstance(t, torch.Tensor)
                 and t.dim() == 4]
        return float(len(codes) * (q.numel() // q.shape[1]) * cout)
    return 0.0


def kernel_bytes(name: str, args, out) -> float:
    """The bytes hand-written kernel `name` moves in one call: each tensor
    of 3 or more dimensions it reads (operands) or writes (results) once;
    (C,) vectors, block partials and per-sample sums are left out as
    negligible (ref epilogue.py:84). The peak test (#1) reads only the
    logits' heat channels, as many as it writes. What a kernel writes
    into tensors it was given counts as `written_in_place` says; an int8
    conv that stores no float output writes none (its empty result)."""
    if name == "peak_scores":
        return float(out.numel() * ((args[0].element_size() if args else 0)
                                    + out.element_size()))
    inplace = written_in_place(name, args)
    if inplace:
        return float(_nbytes([t for t in _tensors(list(args[:4]))
                              + _tensors(out) if t.dim() >= 3])) + inplace
    return float(_nbytes([t for t in _tensors(args) + _tensors(out)
                          if t.dim() >= 3]))


def kernel_flops(name: str, args, out) -> float:
    """Operations of one call of kernel `name`: exact for the int8 convs
    (#14: 2 * output * k*k*Cin; #15: 2 * output * taps), LOSS_OPS per heat
    and regression element for the loss, else KERNELS' operations per
    element of the first operand."""
    if name == "qconv_dense":  # from the input: the output may be codes
        q, w = args[0], args[1]
        return 2.0 * (q.numel() // q.shape[1]) * w.numel()
    if name == "qconv_dw":
        return 2.0 * args[0].numel() * args[1].shape[0]
    if name in LOSS_OPS:
        per_heat, per_reg = LOSS_OPS[name]
        heat = args[1].numel() * args[0].shape[1]
        return float(per_heat * heat + per_reg * (args[0].numel() - heat))
    return float(KERNELS[name][2] * args[0].numel())


def _peak_dtype(cls: str, t: Optional[torch.Tensor]) -> str:
    """The compute dtype whose peak bounds a row: tensor-core work (conv,
    dot) by its operand dtype (f32 as TF32 where PyTorch allows it), all
    else on the CUDA cores in f32."""
    if cls not in ("conv", "dot") or t is None:
        return "fp32"
    if t.dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if t.dtype in (torch.int8, torch.uint8):
        return "int8"
    tf32 = (torch.backends.cudnn.allow_tf32 if cls == "conv"
            else torch.backends.cuda.matmul.allow_tf32)
    return "tf32" if tf32 else "fp32"


class OpCount(TorchDispatchMode):
    """The rows of the work run under it (module docstring). `device`:
    the device type whose operations count ('meta', 'cpu' or 'cuda'; an
    operation on host tensors of a card's run is no row). With `label`,
    each counted call runs inside `record_function(LABEL + row name)`, the
    profiler's join (`trace_rows`). `kernel_calls` lists (kernel, first
    operand's elements, its itemsize, bytes) of each hand-kernel call."""

    def __init__(self, device: str = "meta", label: bool = False):
        super().__init__()
        self.device = device
        self.label = label
        self.rows: Dict[str, Dict] = {}
        self.kernel_calls: List[Tuple[str, int, int, float]] = []
        self._inside = 0

    def __enter__(self):
        if marks.recorder is not None:
            raise RuntimeError("a count is already running")
        marks.recorder = self
        return super().__enter__()

    def __exit__(self, *exc):
        marks.recorder = None
        return super().__exit__(*exc)

    def _labelled(self, name: str):
        if not self.label:
            return contextlib.nullcontext()
        return torch.autograd.profiler.record_function(LABEL + name)

    def _row(self, name: str, opcode: str, cls: str, approx: bool,
             dtype: str, operands, results, kernel=None) -> Dict:
        row = self.rows.get(name)
        if row is None:
            row = self.rows[name] = {
                "name": name, "opcode": opcode, "class": cls, "calls": 0,
                "flops": 0.0, "bytes": 0.0, "operand_bytes": 0.0,
                "approx": approx,
                "peak_dtype": dtype,
                "operands": [[list(t.shape), _DTYPES.get(t.dtype, "?")]
                             for t in operands],
                "results": [[list(t.shape), _DTYPES.get(t.dtype, "?")]
                            for t in results]}
            if kernel is not None:
                row["kernel"] = kernel
        return row

    def kernel(self, name: str, fn: Callable, args, kwargs):
        """A marked wrapper's call (`ops.marks`): one row of kernel
        `name`, the wrapper's own operations hidden."""
        self._inside += 1
        try:
            with self._labelled(name):
                out = fn(*args, **kwargs)
        finally:
            self._inside -= 1
        self._add_kernel(name, args, out)
        return out

    def _add_kernel(self, name: str, args, out) -> None:
        first = _tensors(args)[0]
        nbytes = kernel_bytes(name, args, out)
        num, cls, _ = KERNELS[name]
        row = self._row(name, "custom-call", cls, name not in (
            "qconv_dense", "qconv_dw"), "int8" if cls == "conv" else "fp32",
            [], [], kernel=num)
        row["calls"] += 1
        row["bytes"] += nbytes
        row["operand_bytes"] += (nbytes - kernel_bytes(name, (), out)
                                 - written_in_place(name, args))
        row["flops"] += kernel_flops(name, args, out)
        self.kernel_calls.append((name, first.numel(), first.element_size(),
                                  nbytes))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns = func.namespace
        if self._inside or ns not in ("aten", "helmet") or func.is_view:
            return func(*args, **kwargs)
        op = func._opname
        if ns == "helmet":
            with self._labelled(op):
                out = func(*args, **kwargs)
            self._add_kernel(KERNEL_OF.get(op, op), args, out)
            return out
        sigs = [s for s in map(_sig, list(args) + list(kwargs.values()))
                if s is not None]
        name = "%s(%s)" % (op, ", ".join(sigs))
        with self._labelled(name):
            out = func(*args, **kwargs)
        if self.device == "meta" and op in _CONV_OPS:
            out = _cudnn_layout(args[0], out)
        operands = _tensors(list(args) + list(kwargs.values()))
        results = _tensors(out)
        if not any(t.device.type == self.device
                   for t in operands + results):
            return out
        cast = op in _CASTS and operands and results \
            and operands[0].dtype != results[0].dtype
        opcode = ("convolution" if op in _CONV_OPS else
                  "dot" if op in _DOT_OPS else
                  "reduce-window" if op in _WINDOW_OPS else
                  "convert" if cast else op)
        cls = op_class(name, opcode)
        formula = _flop_formula(func)
        approx = formula is None
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
        elif op in _MOVES and not cast:
            flops = 0.0
        else:
            flops = float(sum(t.numel() for t in results))
        row = self._row(name, opcode, cls, approx,
                        _peak_dtype(cls, operands[0] if operands else None),
                        operands, results)
        row["calls"] += 1
        row["flops"] += flops
        row["bytes"] += float(_nbytes(operands) + _nbytes(results))
        row["operand_bytes"] += float(_nbytes(operands))
        return out

    def sites(self, runs: int = 1) -> List[Tuple[str, int, int, float]]:
        """`kernel_calls` of one of `runs` counted runs."""
        return self.kernel_calls[:len(self.kernel_calls) // runs]

    def table(self, runs: int = 1) -> List[Dict]:
        """The rows per run of `runs` counted runs."""
        out = []
        for r in self.rows.values():
            if r["calls"] % runs:
                raise ValueError("row %s: %d calls in %d runs" % (
                    r["name"], r["calls"], runs))
            out.append(dict(r, calls=r["calls"] // runs,
                            flops=r["flops"] / runs,
                            bytes=r["bytes"] / runs,
                            operand_bytes=r["operand_bytes"] / runs))
        return out


def _cudnn_layout(x: torch.Tensor, out):
    """`out` of a convolution (or its backward) on `meta` tensors with its
    4-D results channels-last where x is, as cuDNN writes them: the meta
    kernels report contiguous results, whose conversion to the layout the
    kernels' wrappers take (`models.hourglass.conv2d`) would count copies
    the card never makes."""
    if not x.is_contiguous(memory_format=torch.channels_last):
        return out

    def fix(t):
        if isinstance(t, torch.Tensor) and t.dim() == 4:
            return t.contiguous(memory_format=torch.channels_last)
        return t
    return type(out)(map(fix, out)) if isinstance(out, tuple) else fix(out)


def _flop_formula(func):
    from torch.utils.flop_counter import flop_registry
    return flop_registry.get(func._overloadpacket)


def count_rows(run: Callable[[], object], device: str = "meta",
               runs: int = 1) -> Tuple[List[Dict], OpCount]:
    """(rows per run, the count) of `runs` calls of `run()` counted on
    `device`. `build_step` and kin make the state a first call would (an
    optimizer's moments), so every call counts the same."""
    with OpCount(device) as count:
        for _ in range(runs):
            run()
    return count.table(runs), count


# ------------------------------------------------------------- the paths

def _config(args, train: bool, **extra):
    """The port's Config of a roofline run: JAX's build_step (train;
    ref :425) or build_predict (ref :469) configuration, `extra` fields
    on top."""
    from ..config import Config
    common = dict(num_stack=args.num_stack,
                  hourglass_inch=args.hourglass_inch, num_cls=2,
                  imsize=args.imsize, batch_size=args.batch,
                  device=args.device, **extra)
    if train:
        return Config(amp=True, remat=args.remat,
                      param_policy=args.param_policy,
                      fwd_dtype=args.fwd_dtype, **common)
    return Config(variant=args.variant,
                  stem_width=min(128, args.hourglass_inch), topk=100,
                  conf_th=0.0, nms_th=0.5, amp=True, **common)


def build_predict(args, device: str) -> Callable[[], object]:
    """One predict of the serve wire (ref roofline.py:469): uint8 images
    normalized on the device, the bf16 network, peak test, decode, NMS,
    at the CLI's architecture, seeded weights (none on `meta`)."""
    import numpy as np
    from ..evaluate import init_weights
    from ..models.hourglass import build_model, cast_convs
    from ..predict import make_predict_fn
    cfg = _config(args, train=False)
    with torch.device("meta" if device == "meta" else "cpu"):
        model = build_model(cfg, dtype=torch.bfloat16)
    if device != "meta":
        model = init_weights(model, 0)
    model = cast_convs(model.to(device).eval(), torch.bfloat16)
    predict = make_predict_fn(model, cfg, normalize="imagenet",
                              device=device)
    shape = (args.batch, args.imsize, args.imsize, 3)
    if device == "meta":
        images = torch.empty(shape, dtype=torch.uint8, device="meta")
    else:
        images = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, shape, dtype=np.uint8)).to(device)
    return lambda: predict.body(images)


def train_arrays(args, device: str):
    """The step's synthetic batch (ref data/synthetic.py:278, pos_rate
    0.01 as JAX's build_step) on `device` (shapes alone on `meta`)."""
    from ..data.synthetic import synthetic_target_batch
    batch = 1 if device == "meta" else args.batch
    arrays = synthetic_target_batch(batch, args.imsize, pos_rate=0.01)
    if device == "meta":
        return [torch.empty((args.batch,) + a.shape[1:],
                            dtype=torch.from_numpy(a).dtype, device="meta")
                for a in arrays]
    return [torch.from_numpy(a).to(device) for a in arrays]


def build_step(args, device: str, **extra) -> Callable[[], object]:
    """One train step (ref roofline.py:425): the flagship `--amp` step of
    the port's `train.make_train_step` at the CLI's configuration (remat,
    param policy, forward dtype; `extra` Config fields), seeded weights,
    Adam."""
    from ..evaluate import init_weights
    from ..models.hourglass import build_model
    from ..optim import make_lr_schedule
    from ..train import init_train_state, make_train_step
    cfg = _config(args, train=True, **extra)
    with torch.device("meta" if device == "meta" else "cpu"):
        model = build_model(cfg, dtype=torch.bfloat16)
    if device != "meta":
        model = init_weights(model, 0)
    opt, _ = init_train_state(cfg, model, device)
    opt.init_state()  # the moments a first step would make
    step = make_train_step(model, opt, make_lr_schedule(cfg, 100), cfg)
    arrs = train_arrays(args, device)
    count = [0]

    def run():
        count[0] += 1
        return step(count[0], *arrs)
    return run


def loss_total(kernel: str) -> Callable:
    """(out, heat, off, wh, mask) -> the loss: "fused" is
    `fused_detection_loss` (#12, #13), "xla" the composition of
    ops/loss.py (`stacked_detection_loss`, JAX's --loss-kernel xla)."""
    from ..ops.loss import fused_detection_loss, stacked_detection_loss
    if kernel == "fused":
        return lambda *a: fused_detection_loss(*a)["total"]
    return lambda *a: stacked_detection_loss(*a, num_cls=2)["total"]


def loss_subprogram_cost(args, kernel: str) -> Dict:
    """The count of the loss alone (`loss_total`), forward and backward
    over the raw stack output at the CLI's shapes (ref roofline.py:503).
    `parsed_bytes` is the count's bytes (the port has no second model);
    the fused record adds `kernel_bytes_analytic`, the kernels' rows."""
    loss = loss_total(kernel)
    targets = train_arrays(args, "meta")[1:]
    m = args.imsize // 4
    out = torch.empty(args.batch, args.num_stack, m, m, 6, device="meta")

    def run():
        loss(out.detach().requires_grad_(True), *targets).backward()
    rows, _ = count_rows(run)
    rec = {"flops": sum(r["flops"] for r in rows),
           "bytes": sum(r["bytes"] for r in rows)}
    rec["parsed_bytes"] = rec["bytes"]
    if kernel == "fused":
        rec["kernel_bytes_analytic"] = sum(r["bytes"] for r in rows
                                           if r.get("kernel"))
    return rec


def ab_step_cost(args, kernel: str) -> Dict:
    """The count of one `--amp` step (forward, `loss_total`, backward,
    Adam)."""
    from ..models.hourglass import build_model
    from ..optim import Adam
    loss = loss_total(kernel)
    cfg = _config(args, train=True)
    with torch.device("meta"):
        model = build_model(cfg, dtype=torch.bfloat16).train()
    opt = Adam(model.parameters(), lr=1e-3)
    opt.init_state()
    images, *targets = train_arrays(args, "meta")

    def run():
        opt.zero_grad(set_to_none=True)
        loss(model(images), *targets).backward()
        opt.step()
    rows, _ = count_rows(run)
    return {"flops": sum(r["flops"] for r in rows),
            "bytes": sum(r["bytes"] for r in rows)}


# ------------------------------------------------------------ the timing

def untraced_ms(run: Callable[[], object], reps: int = 5) -> float:
    """Host wall of `reps` runs between two synchronizes, per run,
    without the profiler (ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def profiled_events(prof) -> List[Tuple[str, bool, int, int, int]]:
    """(name, on the card, start ns, end ns, correlation id) of each event
    of a finished torch.profiler run, read from its kineto results
    (building its FunctionEvent tree would take seconds a run)."""
    from torch.autograd import DeviceType
    return [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
             e.end_ns(), e.correlation_id())
            for e in prof.profiler.kineto_results.events()]


def _by_name(name: str) -> Optional[str]:
    """The hand-kernel row of a device kernel by its name alone, where it
    names one (the train BN passes share kernel templates: None)."""
    hits = {row for row, keys in KERNEL_NAMES.items()
            if any(k in name for k in keys)}
    return hits.pop() if len(hits) == 1 else None


def join_device_times(events, runs: int = 1
                      ) -> Tuple[Dict[str, List[float]], float]:
    """({row name: [device us per run, device operations per run]}, device
    busy us per run) from `profiled_events`. Each device operation joins
    the label (`LABEL` + row) whose host range holds the runtime call
    that launched it (same correlation id; a call's labels never overlap,
    its backward runs while the forward's thread waits), else the hand
    kernel its name gives, else UNATTRIBUTED; the labels' mirrors on the
    card's timeline are no operation. Busy is the union of the device
    operations' ranges, a count apart from the rows' sum."""
    labels = sorted((s, e, n[len(LABEL):]) for n, dev, s, e, _ in events
                    if not dev and n.startswith(LABEL))
    starts = [lab[0] for lab in labels]
    launches = {c: s for n, dev, s, _, c in events
                if not dev and n.startswith("cu")}
    totals: Dict[str, List[int]] = {}
    spans = []
    for name, dev, start, end, corr in events:
        if not dev or name.startswith(LABEL):
            continue
        row = None
        t = launches.get(corr)
        if t is not None:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and labels[i][1] >= t:
                row = labels[i][2]
        row = row or _by_name(name) or UNATTRIBUTED
        rec = totals.setdefault(row, [0, 0])  # ns, operations
        rec[0] += end - start
        rec[1] += 1
        spans.append((start, end))
    busy, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return ({row: [ns / 1e3 / runs, n / runs]
             for row, (ns, n) in totals.items()}, busy / 1e3 / runs)


def trace_rows(run: Callable[[], object], runs: int = 3
               ) -> Tuple[OpCount, Dict[str, List[float]], float, float]:
    """(the count, device times by row per run, device busy us per run,
    traced wall ms per run) of `runs` calls of `run()` on the card,
    counted and labelled, in the active cycle of a profiler schedule: a
    warm-up cycle of one call comes first, so the card's activity is
    being recorded when the counted calls start (in a process that has
    profiled before, a cycle's first calls can otherwise go unrecorded)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        with OpCount("cuda", label=True) as count:
            for _ in range(runs):
                run()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / runs
        prof.step()
    durations, busy = join_device_times(profiled_events(prof), runs)
    return count, durations, busy, traced_ms


# cuDNN's convolution kernels: implicit GEMMs (fprop, dgrad, wgrad), FFT
# and Winograd algorithms and their layout transforms
CONV_KEYS = ("conv", "xmma", "cudnn", "gemm", "cutlass", "fft", "winograd",
             "wgrad", "dgrad", "pointwise_mult_and_sum_complex")


def device_ms_by_name(run: Callable[[int], object], reps: int = 3,
                      counts: Optional[Dict[str, float]] = None
                      ) -> Tuple[Dict[str, float], float]:
    """Call `run(i)` for i < reps under torch.profiler (CUDA activity
    only): (device ms per call by kernel name, traced wall ms per call);
    `counts`, a dict when given, gets device operations per call by
    name."""
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
    by_name: Dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.key] = by_name.get(ev.key, 0.0) \
                + ev.self_device_time_total / 1e3 / reps
            if counts is not None:
                counts[ev.key] = counts.get(ev.key, 0) + ev.count / reps
    return by_name, traced_ms


def kernel_groups(by_name: Dict[str, float], kernels: Sequence[str]
                  ) -> Dict[str, float]:
    """Device ms by group of kernel names: each of `kernels` (a substring
    of a kernel's name), convolution, the optimizer's foreach kernels,
    copies, the rest."""
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


def profile_lines(what: str, wall_ms: float, traced_ms: float,
                  by_name: Dict[str, float], groups: Dict[str, float],
                  top: int) -> List[str]:
    """A device-time breakdown by group, then the `top` kernels by name."""
    busy = sum(by_name.values())
    lines = ["profile %s: wall %.2f (untraced; %.2f under the profiler), "
             "device busy %.2f, idle share %.1f%%; %s" % (
                 what, wall_ms, traced_ms, busy,
                 100.0 * max(0.0, 1 - busy / wall_ms),
                 ", ".join("%s %.2f (%.1f%%)" % (k, v, 100 * v / busy)
                           for k, v in groups.items() if v))]
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        lines.append("    %8.3f ms  %s" % (ms, name[:110]))
    return lines


# -------------------------------------------------------- classification

def classify(rows, peak: float, hbm: float, durations=None, steps: int = 1,
             constants: Optional[Dict[str, float]] = None) -> Dict:
    """Fill intensity / bound / time / shares into `rows`; returns the
    summary totals (ref roofline.py:364). A row's peak is its compute
    dtype's from `constants` (`peak_dtype`), else `peak`; with
    `constants`, `l2_resident_possible` marks a row whose bytes per call
    fit twice over in the card's L2, or whose operands per call fit in
    it (what the operation before it wrote may still be there to read).
    `durations` maps a row name to [total us, calls] over `steps` runs."""
    matched_us = 0.0
    for r in rows:
        dur = durations.get(r["name"]) if durations else None
        if dur is not None:
            r["time_us"] = round(dur[0] / steps, 3)
            r["trace_calls"] = dur[1]
            matched_us += dur[0]
        else:
            r["time_us"] = None
        p = constants[r["peak_dtype"]] if constants and "peak_dtype" in r \
            else peak
        b = r["bytes"]
        f = r["flops"]
        r["intensity"] = round(f / b, 3) if b else math.inf
        r["bound"] = "tensor" if (b == 0 or f / b >= p / hbm) else "hbm"
        r["t_roofline_us"] = round(max(f / p, b / hbm) * 1e6, 3)
        if constants:
            calls = max(r.get("calls") or 1, 1)
            r["l2_resident_possible"] = bool(
                2 * b / calls <= constants["l2_bytes"]
                or r.get("operand_bytes", math.inf) / calls
                <= constants["l2_bytes"])
    total_bytes = sum(r["bytes"] for r in rows) or 1.0
    total_time = sum(r["time_us"] for r in rows
                     if r["time_us"] is not None) or None
    for r in rows:
        r["pct_bytes"] = round(100.0 * r["bytes"] / total_bytes, 2)
        r["pct_time"] = (round(100.0 * r["time_us"] / total_time, 2)
                         if total_time and r["time_us"] is not None
                         else None)
    rows.sort(key=lambda r: (-(r["time_us"] or 0.0), -r["bytes"]))
    return {"total_bytes": total_bytes,
            "total_time_us_per_step": total_time,
            "ridge_flops_per_byte": round(peak / hbm, 2),
            "matched_trace_us": round(matched_us, 1)}


def class_table(rows) -> Dict[str, Dict]:
    """class_totals with each class's device us and calls per run, and
    the share of them in hand-kernel rows, beside."""
    out = class_totals(rows)
    for c in OP_CLASSES:
        mine = [r for r in rows
                if (r.get("class") or op_class(r["name"], r["opcode"])) == c]
        out[c]["time_us"] = round(sum(r["time_us"] or 0.0 for r in mine), 3)
        out[c]["calls"] = sum(r.get("calls", 0) for r in mine)
        out[c]["kernel_time_us"] = round(sum(
            r["time_us"] or 0.0 for r in mine if r.get("kernel")), 3)
    return out


def _markdown(rows, meta, top: int) -> str:
    """The artifact's top rows as a table (ref roofline.py:398)."""
    s = meta["summary"]
    lines = ["# Roofline attribution — %s"
             % ("predict (serve wire)"
                if (meta["config"] or {}).get("mode") == "predict"
                else "train step"),
             "",
             "platform=%s  device=%s  card=%s  config=%s" % (
                 meta["platform"], meta["device_kind"], meta["card"],
                 json.dumps(meta["config"])),
             "ridge=%.1f FLOP/byte (%.1f TFLOP/s / %.0f GB/s); busy %s us, "
             "wall %s us, idle %s, mfu %s" % (
                 s["ridge_flops_per_byte"], meta["peak_flops"] / 1e12,
                 meta["hbm_bytes_per_s"] / 1e9, s.get("busy_us"),
                 s.get("wall_us"), s.get("idle_share"), s.get("mfu")),
             "",
             "| op | kind | calls | time us/step | % time | MB | % bytes | "
             "GFLOP | FLOP/byte | bound | roofline % | L2 |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows[:top]:
        t = r["time_us"]
        lines.append(
            "| %s | %s | %s | %s | %s | %.2f | %.1f | %.3f | %s | %s | %s "
            "| %s |" % (
                r["name"][:64], r["opcode"], r.get("calls", "-"),
                "%.1f" % t if t is not None else "-",
                "%.1f" % r["pct_time"] if r["pct_time"] is not None
                else "-",
                r["bytes"] / 2**20, r["pct_bytes"], r["flops"] / 1e9,
                "inf" if r["intensity"] == math.inf else
                "%.1f" % r["intensity"], r["bound"],
                "%.0f" % (100.0 * r["t_roofline_us"] / t) if t else "-",
                "yes" if r.get("l2_resident_possible") else "no"))
    lines += ["", "| class | time us/step | of it hand kernels | calls | MB "
              "| % bytes | GFLOP | rows |",
              "|---|---|---|---|---|---|---|---|"]
    for c, v in s["by_class"].items():
        lines.append("| %s | %.1f | %.1f | %d | %.1f | %.1f | %.3f | %d |" % (
            c, v["time_us"], v["kernel_time_us"], v["calls"],
            v["bytes"] / 2**20, v["pct_bytes"], v["flops"] / 1e9, v["ops"]))
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------------ diff

def diff_rooflines(baseline: dict, candidate: dict) -> dict:
    """Join two roofline-v1 artifacts into byte/FLOP delta tables (ref
    roofline.py:622): per class, the rows present on both sides, each
    side's top unmatched rows. Positive delta_pct = the candidate moves
    fewer bytes."""
    for side, art in (("baseline", baseline), ("candidate", candidate)):
        if art.get("schema") != SCHEMA:
            raise ValueError("--diff: %s is not a %s artifact (schema=%r)"
                             % (side, SCHEMA, art.get("schema")))
    rows_a, rows_b = baseline["fusions"], candidate["fusions"]
    cls_a, cls_b = class_totals(rows_a), class_totals(rows_b)
    total_a = sum(v["bytes"] for v in cls_a.values())
    total_b = sum(v["bytes"] for v in cls_b.values())

    def pct(delta, base):
        return round(100.0 * delta / base, 2) if base else None

    by_class = {}
    for c in OP_CLASSES:
        a, b = cls_a[c], cls_b[c]
        by_class[c] = {
            "bytes_baseline": a["bytes"], "bytes_candidate": b["bytes"],
            "bytes_delta": a["bytes"] - b["bytes"],
            "bytes_delta_pct": pct(a["bytes"] - b["bytes"], a["bytes"]),
            "flops_baseline": a["flops"], "flops_candidate": b["flops"],
            "ops_baseline": a["ops"], "ops_candidate": b["ops"],
            "pct_of_step_baseline": a["pct_bytes"],
            "pct_of_step_candidate": b["pct_bytes"],
        }
    nonconv_a = total_a - cls_a["conv"]["bytes"]
    nonconv_b = total_b - cls_b["conv"]["bytes"]
    ce_a = cls_a["convert"]["bytes"] + cls_a["elementwise"]["bytes"]
    ce_b = cls_b["convert"]["bytes"] + cls_b["elementwise"]["bytes"]

    named_a = {r["name"]: r for r in rows_a}
    named_b = {r["name"]: r for r in rows_b}
    matched = []
    for name in set(named_a) & set(named_b):
        da = named_a[name]["bytes"] - named_b[name]["bytes"]
        if da:
            matched.append({
                "name": name, "class": op_class(name,
                                                named_a[name]["opcode"]),
                "bytes_baseline": named_a[name]["bytes"],
                "bytes_candidate": named_b[name]["bytes"],
                "bytes_delta": da})
    matched.sort(key=lambda r: -abs(r["bytes_delta"]))

    def top_unmatched(rows, other_names):
        un = [r for r in rows if r["name"] not in other_names]
        un.sort(key=lambda r: -r["bytes"])
        return [{"name": r["name"],
                 "class": op_class(r["name"], r["opcode"]),
                 "bytes": r["bytes"]} for r in un[:15]]

    return {
        "schema": DIFF_SCHEMA,
        "baseline": {"config": baseline.get("config"),
                     "platform": baseline.get("platform"),
                     "total_bytes": total_a},
        "candidate": {"config": candidate.get("config"),
                      "platform": candidate.get("platform"),
                      "total_bytes": total_b},
        "platform_match": baseline.get("platform")
        == candidate.get("platform"),
        "total_bytes_delta_pct": pct(total_a - total_b, total_a),
        "nonconv_bytes_baseline": nonconv_a,
        "nonconv_bytes_candidate": nonconv_b,
        "nonconv_bytes_delta_pct": pct(nonconv_a - nonconv_b, nonconv_a),
        "convert_plus_elementwise_baseline": ce_a,
        "convert_plus_elementwise_candidate": ce_b,
        "convert_plus_elementwise_delta_pct": pct(ce_a - ce_b, ce_a),
        "conv_bytes_delta_pct": pct(
            cls_a["conv"]["bytes"] - cls_b["conv"]["bytes"],
            cls_a["conv"]["bytes"]),
        "by_class": by_class,
        "matched_fusions": matched[:30],
        "top_baseline_only": top_unmatched(rows_a, set(named_b)),
        "top_candidate_only": top_unmatched(rows_b, set(named_a)),
    }


def _diff_markdown(d: dict) -> str:
    """The diff's class table and top movers (ref roofline.py:707)."""
    lines = ["# Roofline diff — per-op-class HBM bytes",
             "",
             "baseline: %s  candidate: %s" % (
                 json.dumps(d["baseline"]["config"]),
                 json.dumps(d["candidate"]["config"])),
             "",
             "| class | baseline MB | candidate MB | delta MB | delta % | "
             "% of step (base -> cand) |",
             "|---|---|---|---|---|---|"]
    for c in OP_CLASSES:
        r = d["by_class"][c]
        lines.append("| %s | %.1f | %.1f | %.1f | %s | %.1f -> %.1f |" % (
            c, r["bytes_baseline"] / 2**20, r["bytes_candidate"] / 2**20,
            r["bytes_delta"] / 2**20,
            "%.1f" % r["bytes_delta_pct"]
            if r["bytes_delta_pct"] is not None else "-",
            r["pct_of_step_baseline"], r["pct_of_step_candidate"]))
    lines += ["",
              "total: %.1f%%  non-conv: %.1f%%  convert+elementwise: "
              "%.1f%%  conv: %s%%  (positive = candidate moves fewer "
              "bytes)" % (
                  d["total_bytes_delta_pct"] or 0.0,
                  d["nonconv_bytes_delta_pct"] or 0.0,
                  d["convert_plus_elementwise_delta_pct"] or 0.0,
                  d["conv_bytes_delta_pct"]),
              "",
              "## Top matched-row movers", "",
              "| row | class | baseline MB | candidate MB |",
              "|---|---|---|---|"]
    for r in d["matched_fusions"][:15]:
        lines.append("| %s | %s | %.2f | %.2f |" % (
            r["name"][:48], r["class"], r["bytes_baseline"] / 2**20,
            r["bytes_candidate"] / 2**20))
    return "\n".join(lines) + "\n"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def default_out(name: str) -> str:
    return os.path.join(REPO, "artifacts",
                        os.environ.get("GRAFT_ROUND") or ROUND, "roofline",
                        name)


def write_artifact(path: str, obj: dict, markdown: str) -> None:
    """The JSON (atomic) and its markdown beside."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_json(path, obj, indent=1)
    atomic_write_bytes(path.rsplit(".", 1)[0] + ".md", markdown.encode())


def run_diff(args) -> dict:
    """--diff: pure file work, no device (ref roofline.py:744)."""
    base_path, cand_path = args.diff
    with open(base_path) as f:
        baseline = json.load(f)
    with open(cand_path) as f:
        candidate = json.load(f)
    d = diff_rooflines(baseline, candidate)
    d["inputs"] = {"baseline": base_path, "candidate": cand_path}
    if not d["platform_match"]:
        log("WARNING: diffing across platforms (%s vs %s): rows differ by "
            "pipeline, read the class table as a trend"
            % (baseline.get("platform"), candidate.get("platform")))
    out_path = args.out or default_out(
        "roofline_diff%s.json" % (("_" + args.tag) if args.tag else ""))
    write_artifact(out_path, d, _diff_markdown(d))
    log("wrote %s" % out_path)
    print(json.dumps({k: v for k, v in d.items()
                      if k not in ("matched_fusions", "top_baseline_only",
                                   "top_candidate_only", "by_class")}
                     | {"out": out_path}))
    return d


# ------------------------------------------------------------------- CLI

def build_parser() -> argparse.ArgumentParser:
    """JAX's flags and defaults (ref roofline.py:778) less its TPU
    switches (--platform, --loss-kernel, --epilogue, --block-fuse, --cpu:
    the port has one path), plus --device."""
    ap = argparse.ArgumentParser(
        prog="python -m real_time_helmet_detection_tpu_torch.obs.roofline",
        description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--imsize", type=int, default=512)
    ap.add_argument("--num-stack", type=int, default=1)
    ap.add_argument("--hourglass-inch", type=int, default=128)
    ap.add_argument("--mode", default="train", choices=["train", "predict"])
    ap.add_argument("--variant", default="residual",
                    choices=["residual", "depthwise", "ghost"])
    ap.add_argument("--steps", type=int, default=2,
                    help="train steps per profiled window (at least "
                         "MIN_RUNS are profiled)")
    ap.add_argument("--remat", default="none",
                    choices=["none", "stacks", "full"])
    ap.add_argument("--param-policy", default="fp32",
                    choices=["fp32", "bf16-compute"])
    ap.add_argument("--fwd-dtype", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--diff", nargs=2, metavar=("BASELINE", "CANDIDATE"))
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--no-trace", action="store_true",
                    help="the count alone, on meta tensors (no timing)")
    ap.add_argument("--ab-loss-kernel", action="store_true",
                    help="also count the loss fused (#12/#13) and composed")
    ap.add_argument("--out", default="")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: the count alone, against the card's "
                         "constants")
    return ap


MIN_RUNS = 3  # profiled runs at least


def card_line() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def roofline(args) -> Dict:
    """One roofline artifact (the module docstring) of `args`' path."""
    from ..predict import resolve_device
    dev = resolve_device(args.device)
    predict_mode = args.mode == "predict"
    build = build_predict if predict_mode else build_step
    if dev.type == "cuda":
        kind = meta_kind = torch.cuda.get_device_name(dev)
    else:
        kind, meta_kind = "cpu", TARGET_CARD
    const = card_constants(meta_kind)
    peak, hbm = const["bf16"], const["hbm_bytes_per_s"]
    steps = 1 if predict_mode else args.steps
    runs = max(MIN_RUNS, steps)
    durations, trace_note, timing = None, "disabled (--no-trace)", {}
    seconds, mark = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = round(now - mark[0], 3)
        mark[0] = now
    if args.no_trace or dev.type != "cuda":
        if not args.no_trace:
            trace_note = "not measured: no card (--device cpu)"
        run = build(args, "meta")
        lap("build")
        count = count_rows(run)[1]
        lap("count")
        rows, sites = count.table(), count.sites()
    else:
        run = build(args, "cuda")
        lap("build")
        count, durations, busy, traced_ms = trace_rows(run, runs)
        rows, sites = count.table(runs), count.sites(runs)
        lap("trace")
        wall_ms = untraced_ms(run)
        lap("untraced")
        trace_note = "%d profiled runs, %d rows timed" % (runs,
                                                          len(durations))
        timing = {"busy_us": round(busy, 3),
                  "wall_us": round(wall_ms * 1e3, 3),
                  "traced_wall_us": round(traced_ms * 1e3, 3),
                  "idle_share": round(max(0.0, 1 - busy / (wall_ms * 1e3)),
                                      4)}
        if durations.get(UNATTRIBUTED):
            rows.append({"name": UNATTRIBUTED, "opcode": "none",
                         "class": "elementwise", "calls": 0, "flops": 0.0,
                         "bytes": 0.0, "approx": False,
                         "peak_dtype": "fp32"})
    summary = classify(rows, peak, hbm, durations, constants=const)
    total_flops = sum(r["flops"] for r in rows)
    summary["by_class"] = class_table(rows)
    summary["total_flops"] = total_flops
    summary["launches"] = sum(r["calls"] for r in rows)  # counted calls
    summary.update(timing)
    if timing:
        summary["unattributed_us"] = round(
            (durations.get(UNATTRIBUTED) or [0.0])[0], 3)
        summary["mfu"] = round(total_flops / (timing["wall_us"] * 1e-6)
                               / peak, 5)
    meta = {
        "schema": SCHEMA,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device_kind": kind,
        "card": card_line() if dev.type == "cuda" else None,
        "peak_flops": peak,
        "hbm_bytes_per_s": hbm,
        "constants": dict(const, card=meta_kind),
        "config": {"batch": args.batch, "imsize": args.imsize,
                   "num_stack": args.num_stack, "steps": steps,
                   "runs": runs, "mode": args.mode, "variant": args.variant,
                   "width": args.hourglass_inch, "remat": args.remat,
                   "param_policy": args.param_policy,
                   "fwd_dtype": args.fwd_dtype, "amp": True},
        "totals": {"flops": total_flops,
                   "parsed_bytes": summary["total_bytes"]},
        "trace": trace_note,
        "seconds": seconds,
        "summary": summary,
        # each hand-kernel call of one run: (kernel, its first operand's
        # elements, itemsize, bytes), the sites of its rows
        "kernel_sites": [list(c) for c in sites],
        "note": ("rows are the ATen operations of one %s counted on shapes "
                 "(operand + result bytes; FLOPs exact for conv/dot, else "
                 "1 per element, approx), each hand kernel one row of its "
                 "own transfers; classified against %s's constants"
                 % ("predict" if predict_mode else "train step",
                    meta_kind)),
    }
    if args.ab_loss_kernel and not predict_mode:
        meta["loss_kernel_ab"] = loss_kernel_ab(args, summary["total_bytes"])
        log("loss-kernel A/B: %s" % json.dumps(
            {k: v for k, v in meta["loss_kernel_ab"].items()
             if "pct" in k or "basis" in k}))
    meta["fusions"] = rows
    return meta


def loss_kernel_ab(args, step_bytes: float) -> Dict:
    """The count (never a timing) of the loss as #12/#13 move it beside
    ops/loss.py's composition, under JAX's keys (ref roofline.py:948)."""
    ab = {}
    for variant in ("xla", "fused"):
        ab["step_%s" % variant] = ab_step_cost(args, variant)
        ab["loss_only_%s" % variant] = loss_subprogram_cost(args, variant)
    lx = ab["loss_only_xla"]["parsed_bytes"]
    lf = ab["loss_only_fused"]["parsed_bytes"]
    ab["fused_bytes_basis"] = "parsed"
    if lx and lf:
        ab["loss_bytes_delta_pct"] = round(100.0 * (lx - lf) / lx, 2)
        ab["step_bytes_delta_pct_projected"] = round(
            100.0 * (lx - lf) / step_bytes, 3)
    sx, sf = ab["step_xla"]["bytes"], ab["step_fused"]["bytes"]
    ab["step_bytes_delta_pct_cost_analysis"] = round(100.0 * (sx - sf) / sx,
                                                     2)
    return ab


def main(argv=None) -> Dict:
    args = build_parser().parse_args(argv)
    if args.diff:
        return run_diff(args)
    meta = roofline(args)
    predict_mode = args.mode == "predict"
    out_path = args.out or default_out("roofline_%s%s%s.json" % (
        meta["platform"], "_predict" if predict_mode else "",
        ("_" + args.tag) if args.tag else ""))
    write_artifact(out_path, meta, _markdown(meta["fusions"], meta,
                                             args.top))
    log("wrote %s (+ .md)" % out_path)
    print(json.dumps({k: v for k, v in meta.items()
                      if k not in ("fusions", "kernel_sites")}
                     | {"n_ops": len(meta["fusions"]), "out": out_path}))
    return meta


if __name__ == "__main__":
    from ..runtime import run_as_job
    run_as_job(main)
