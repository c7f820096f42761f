"""Export-graph audit of the public entry points (graftlint layer 1), on
the CPU at tiny shapes.

Port of ref real_time_helmet_detection_tpu/analysis/trace_audit.py: where
JAX traces each entry point to a jaxpr and StableHLO, the port takes it
through `torch.export` (`export.build_export_fn` / `export.trace`, the
export CLI's own path, for the predicts) and inspects the exported
graph. The entry points, at JAX's audit shapes (1 stack, width 16, 64^2,
batch 2, topk 16; ref trace_audit.py:238-239):

* predict in f32, in bf16 (`--amp`) and on the uint8 wire (normalization
  in the program), and predict of each architecture of `TIER_AUDIT`;
* the serve buckets 1, 2 and 4 (the uint8 wire at that batch, what each
  of the engine's CUDA graphs holds);
* the int8 predict (the folded twin, scales from a synthetic calibration);
* the train step under each of: no option, `--remat stacks`,
  `--param-policy bf16-compute`, `--fwd-dtype int8`, `--sentinel`,
  `--telemetry`, `--distill` (an in-memory teacher). Its forward and
  loss are exported in train mode (`TrainLoss`; the sentinel and the
  telemetry change only the step's tail, so their forward is the plain
  one's), and one real CPU step of each checks the step's own ops and
  storages (`step_findings`).

The rules:

* `trace/dynamic-shape`    — a symbolic dim in the exported graph;
* `trace/trace-failure`    — the entry no longer exports (or builds);
* `trace/f64`              — a float64 or complex128 tensor anywhere in
                             the graph's metadata;
* `trace/host-callback`    — an op that syncs the host inside the graph
                             or the real step (`aten._local_scalar_dense`,
                             `nonzero`, `masked_select`, ...), or any op
                             whose output shape depends on the data (an
                             unbacked symbol);
* `trace/realloc`          — the counterpart of JAX's `trace/donation`: a
                             parameter, BN buffer or optimizer state whose
                             storage (`data_ptr`) changes across one real
                             CPU step, a copy the in-place step should not
                             make;
* `trace/retrace-unstable` — two exports of one entry with different
                             signatures (sha256 of the graph code and the
                             input specs), or two architectures of the
                             tier grid exporting to the same program.

No export touches a card: the `helmet` ops export as calls through their
fakes, so the graph is the program the card runs.
"""

from __future__ import annotations

import hashlib
import re
import types
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import Finding

_TINY = dict(num_stack=1, hourglass_inch=16, num_cls=2, imsize=64)
_BATCH = 2
TIER_AUDIT = (
    ("edge", dict(variant="ghost", num_stack=1, hourglass_inch=8,
                  stem_width=8)),
    ("depthwise-variant", dict(variant="depthwise", num_stack=1,
                               hourglass_inch=8, stem_width=8)),
    ("quality", dict(variant="residual", num_stack=2,
                     hourglass_inch=16, stem_width=16)),
)
SERVE_BUCKETS_AUDIT = (1, 2, 4)
TRAIN_MODES = ("none", "remat=stacks", "param=bf16-compute", "fwd=int8",
               "sentinel", "telemetry", "distill")
# the modes whose forward and loss differ from the plain one's (the
# sentinel and telemetry change only the step's tail, which the real
# step's check covers)
TRAIN_EXPORTS = ("none", "remat=stacks", "param=bf16-compute", "fwd=int8",
                 "distill")

_BAD_DTYPES = ("float64", "complex128")
# ops that read a value back to the host, or whose output shape is the
# data's
HOST_SYNC_OPS = ("_local_scalar_dense", "item", "nonzero", "masked_select",
                 "unique", "_unique", "_unique2", "unique_consecutive",
                 "unique_dim", "repeat_interleave", "equal",
                 "_assert_async", "is_nonzero", "allclose")


# ---------------------------------------------------------------------------
# the tiny entry points (shared with transfer_audit and chip_smoke)


def tiny_config(**kw):
    """A Config at the audit's shapes, `kw` over `_TINY`."""
    from ..config import Config  # the package's modules import this one
    base = dict(_TINY, device="cpu", topk=16, conf_th=0.0, nms_th=0.5,
                batch_size=_BATCH)
    base.update(kw)
    return Config(**base)


def tiny_model(cfg, seed: int = 0):
    """`cfg`'s model (f32 parameters; compute dtype bf16 under --amp)
    with the port's seeded init, on the CPU."""
    from ..evaluate import init_weights
    from ..models.hourglass import build_model
    model = build_model(cfg, dtype=torch.bfloat16 if cfg.amp else None)
    return init_weights(model, seed)


def tiny_predict(normalize: Optional[str] = None, amp: bool = False,
                 arch: Optional[dict] = None, cascade_summary: bool = False,
                 int8: bool = False, batch: int = _BATCH, device="cpu"):
    """(Predict, host images) of the tiny model on `device`: f32 or bf16
    (`amp`), normalized float32 images or, with `normalize`, the uint8
    wire; `int8`: the folded twin with scales calibrated on two
    synthetic batches."""
    import numpy as np

    from ..models.hourglass import cast_convs
    from ..ops.quant import calibrate_scales, synthetic_calibration_batches
    from ..predict import make_predict_fn
    cfg = tiny_config(amp=amp, infer_dtype="int8" if int8 else "bf16",
                      **(arch or {}))
    model = tiny_model(cfg)
    scales = None
    if int8:
        scales = calibrate_scales(
            cfg, model.state_dict(),
            synthetic_calibration_batches(_BATCH, _TINY["imsize"], n=2),
            device=device)
    elif amp:
        cast_convs(model, model.dtype)
    predict = make_predict_fn(model, cfg, normalize=normalize,
                              device=device, quant_scales=scales,
                              cascade_summary=cascade_summary)
    shape = (batch, _TINY["imsize"], _TINY["imsize"], 3)
    images = (np.zeros(shape, np.uint8) if normalize
              else np.zeros(shape, np.float32))
    return predict, images


def tiny_train(mode: str = "none", device="cpu") -> types.SimpleNamespace:
    """One train-step configuration of `TRAIN_MODES` on `device`: a
    namespace of `model`, `step`, `cfg`, host `batch`, `optimizer`,
    `ema`, `sentinel` and `distiller`, built as `train.train` builds them
    (the `--distill` teacher in memory: the same tiny architecture,
    another seed)."""
    from ..data.synthetic import synthetic_target_batch
    from ..optim import make_lr_schedule
    from ..train import (Distiller, Sentinel, init_train_state,
                         make_train_step)
    kw = {"none": {}, "remat=stacks": dict(remat="stacks"),
          "param=bf16-compute": dict(amp=True,
                                     param_policy="bf16-compute"),
          "fwd=int8": dict(fwd_dtype="int8"),
          "sentinel": dict(sentinel=True),
          "telemetry": dict(telemetry=True),
          "distill": dict(distill="<in memory>")}[mode]
    cfg = tiny_config(train_flag=True, **kw)
    model = tiny_model(cfg)
    dev = torch.device(device)
    optimizer, ema = init_train_state(cfg, model, dev)
    sentinel = Sentinel(cfg, model, optimizer, ema, dev) \
        if cfg.sentinel else None
    distiller = None
    if cfg.distill:
        teacher = tiny_model(cfg, seed=1).to(dev).eval()
        for p in teacher.parameters():
            p.requires_grad_(False)
        distiller = Distiller(teacher, cfg.distill_alpha, cfg.num_cls,
                              cfg.normalized_coord)
    step = make_train_step(model, optimizer, make_lr_schedule(cfg, 10), cfg,
                           ema=ema, sentinel=sentinel, distiller=distiller)
    batch = synthetic_target_batch(_BATCH, _TINY["imsize"], pos_rate=0.05)
    return types.SimpleNamespace(model=model, step=step, cfg=cfg,
                                 batch=batch, optimizer=optimizer, ema=ema,
                                 sentinel=sentinel, distiller=distiller)


class TrainLoss(torch.nn.Module):
    """The train step's forward and loss as a module to export:
    (images, heat, off, wh, mask) -> the losses by name, in train mode
    (the BN statistics' updates are buffer mutations of the graph)."""

    def __init__(self, model, cfg, distiller=None):
        super().__init__()
        self.model = model
        self.cfg = cfg
        self.distiller = distiller

    def forward(self, images, heat, off, wh, mask):
        from ..train import loss_fn
        _, losses = loss_fn(self.model, images, heat, off, wh, mask,
                            self.cfg, self.distiller)
        return tuple(losses[k] for k in sorted(losses))


def export_predict(predict, images):
    """`torch.export` of a predict's body at its images' shape (the
    export CLI's `build_export_fn`/`trace` path)."""
    from ..export import PredictProgram, trace
    return trace(PredictProgram(predict), images.shape[0], images.shape[1],
                 torch.from_numpy(images).dtype, "cpu")


def export_train(mode: str):
    """`torch.export` of a train configuration's forward and loss."""
    t = tiny_train(mode)
    args = tuple(torch.from_numpy(a) for a in t.batch)
    return torch.export.export(TrainLoss(t.model, t.cfg, t.distiller), args)


# ---------------------------------------------------------------------------
# the rules over one exported program


def signature(ep) -> str:
    """sha256 of the graph's code and its input specs; object addresses
    masked (process noise, not program content)."""
    text = ep.graph_module.code + "\n" + "\n".join(
        str(s) for s in ep.graph_signature.input_specs)
    text = re.sub(r" at 0x[0-9a-f]+", " at 0xX", text)
    return hashlib.sha256(text.encode()).hexdigest()


def _vals(node):
    val = node.meta.get("val")
    if isinstance(val, (list, tuple)):
        return [v for v in val if hasattr(v, "shape")]
    return [val] if hasattr(val, "shape") else []


def _symbols(val) -> Tuple[bool, bool]:
    """(has a backed symbolic dim, has an unbacked one) of a tensor."""
    backed = unbacked = False
    for d in val.shape:
        if isinstance(d, torch.SymInt):
            names = {str(s) for s in d.node.expr.free_symbols}
            if any(n.startswith("u") for n in names):
                unbacked = True
            if any(not n.startswith("u") for n in names):
                backed = True
    return backed, unbacked


def graph_findings(ep, entry: str) -> List[Finding]:
    """dynamic-shape, f64 and host-callback over an exported program."""
    out: List[Finding] = []
    path = "<%s>" % entry
    dyn = f64 = False
    syncs = set()
    for node in ep.graph.nodes:
        if node.op == "call_function":
            name = str(getattr(node.target, "__name__", node.target))
            op = name.split(".")[0]
            if op in HOST_SYNC_OPS and op not in syncs:
                syncs.add(op)
                out.append(Finding(
                    rule="trace/host-callback", path=path, context=entry,
                    message="op %r in the exported graph: a read back to "
                            "the host (or a data-dependent shape) inside "
                            "the program, which a CUDA graph cannot hold "
                            "and which stalls the launch queue" % name))
        for val in _vals(node):
            backed, unbacked = _symbols(val)
            if unbacked and "unbacked" not in syncs:
                syncs.add("unbacked")
                out.append(Finding(
                    rule="trace/host-callback", path=path, context=entry,
                    message="node %s has a data-dependent shape %s: its "
                            "size is read back from the card"
                            % (node.name, tuple(val.shape))))
            if backed and not dyn:
                dyn = True
                out.append(Finding(
                    rule="trace/dynamic-shape", path=path, context=entry,
                    message="node %s has a symbolic shape %s: the "
                            "program's shapes must be fixed (one CUDA "
                            "graph per bucket)" % (node.name,
                                                   tuple(val.shape))))
            if str(val.dtype).replace("torch.", "") in _BAD_DTYPES \
                    and not f64:
                f64 = True
                out.append(Finding(
                    rule="trace/f64", path=path, context=entry,
                    message="%s tensor at node %s: a silent wide dtype "
                            "doubles the bytes and leaves the kernels' "
                            "path" % (val.dtype, node.name)))
    return out


class OpRecorder(torch.utils._python_dispatch.TorchDispatchMode):
    """The aten ops a region dispatches, by name (packet name)."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops.add(func.__name__.split(".")[0])
        return func(*args, **(kwargs or {}))


def moved_storages(tensors: Callable[[], Dict[str, torch.Tensor]],
                   run: Callable[[], object]) -> List[str]:
    """The names among `tensors()` whose storage (`data_ptr`) `run()`
    changed, or that it dropped."""
    before = {k: t.data_ptr() for k, t in tensors().items()}
    run()
    after = {k: t.data_ptr() for k, t in tensors().items()}
    return sorted(k for k in before if after.get(k) != before[k])


def state_tensors(model, optimizer=None) -> Dict[str, torch.Tensor]:
    """The tensors a program keeps on the card, by name: the model's
    parameters and buffers and, for a train step, the optimizer's state
    and fp32 masters (what the step updates in place)."""
    out = dict(("param:" + n, p) for n, p in model.named_parameters())
    out.update(("buffer:" + n, b) for n, b in model.named_buffers())
    if optimizer is not None:
        inner = getattr(optimizer, "inner", optimizer)
        for i, st in enumerate(inner.state.values()):
            out.update(("opt:%d.%s" % (i, k), v) for k, v in st.items()
                       if torch.is_tensor(v))
        for i, m in enumerate(getattr(optimizer, "masters", [])):
            out["master:%d" % i] = m
    return out


def step_findings(mode: str, entry: str) -> List[Finding]:
    """One warm step, then one step more on the CPU with its aten ops
    recorded: every parameter, BN buffer, optimizer-state tensor and
    master keeps its storage (`trace/realloc`), and the step's own ops
    (the optimizer, the sentinel's select, the telemetry norms, which
    the exported forward does not hold) read nothing back to the host
    (`trace/host-callback`)."""
    t = tiny_train(mode)
    args = tuple(torch.from_numpy(a) for a in t.batch)
    t.step(0, *args)
    rec = OpRecorder()

    def run():
        with rec:
            t.step(1, *args)

    moved = moved_storages(lambda: state_tensors(t.model, t.optimizer),
                           run)
    out: List[Finding] = []
    if moved:
        out.append(Finding(
            rule="trace/realloc", path="<%s>" % entry, context=entry,
            message="%d state tensor(s) changed storage across one step "
                    "(%s): the step copies state it should update in "
                    "place" % (len(moved), ", ".join(moved[:4]))))
    syncs = sorted(rec.ops & set(HOST_SYNC_OPS))
    if syncs:
        out.append(Finding(
            rule="trace/host-callback", path="<%s>" % entry, context=entry,
            message="the step runs %s: a read back to the host inside "
                    "every step" % ", ".join(syncs)))
    return out


def audit_entry(build: Callable, entry: str, retrace: bool = True
                ) -> Tuple[List[Finding], Optional[str]]:
    """(findings, signature or None) of one entry: `build()` returns its
    exported program and is called again for the retrace check. A build
    or export failure is the finding, never a crash."""
    try:
        ep = build()
        out = graph_findings(ep, entry)
        sig = signature(ep)
        if retrace and signature(build()) != sig:
            out.append(Finding(
                rule="trace/retrace-unstable", path="<%s>" % entry,
                context=entry,
                message="two exports of the same entry gave different "
                        "graphs: export-time nondeterminism (clock, RNG, "
                        "dict order) — a rebuilt program is another "
                        "program"))
        return out, sig
    except Exception as e:  # noqa: BLE001 — the failure is the finding
        return [Finding(
            rule="trace/trace-failure", path="<%s>" % entry, context=entry,
            message="entry point failed to export (%s: %s)"
                    % (type(e).__name__,
                       (str(e).splitlines() or ["?"])[0][:200]))], None


def export_entries() -> Dict[str, Callable]:
    """name -> () -> ExportedProgram, every audited entry point."""
    def pred(**kw):
        return lambda: export_predict(*tiny_predict(**kw))

    out = {"predict": pred(),
           "predict[bf16]": pred(amp=True),
           "predict[uint8]": pred(normalize="imagenet"),
           "predict[int8]": pred(int8=True)}
    for b in SERVE_BUCKETS_AUDIT:
        out["serve_predict[b=%d]" % b] = pred(normalize="imagenet", batch=b)
    for tier, arch in TIER_AUDIT:
        out["predict[tier=%s]" % tier] = pred(arch=dict(arch))
    for mode in TRAIN_EXPORTS:
        out["train_step[%s]" % mode] = (lambda m=mode: export_train(m))
    return out


def audit_repo_entry_points(only: Optional[Sequence[str]] = None
                            ) -> List[Finding]:
    """The trace rules over every entry point (or `only` those named),
    each exported twice for the retrace check except the train
    configurations past the plain one (their graphs take the longest
    and share its code path), the step check over every train
    configuration, and the tier grid: distinct architectures must export
    to distinct programs."""
    findings: List[Finding] = []
    sigs: Dict[str, str] = {}
    for name, build in export_entries().items():
        if only is not None and name not in only:
            continue
        retrace = not name.startswith("train_step[") \
            or name == "train_step[none]"
        found, sig = audit_entry(build, name, retrace=retrace)
        findings += found
        if sig is not None:
            sigs[name] = sig
    for mode in TRAIN_MODES:
        name = "train_step[%s]" % mode
        if only is not None and name not in only:
            continue
        try:
            findings += step_findings(mode, name)
        except Exception as e:  # noqa: BLE001 — reported as a failure
            findings.append(Finding(
                rule="trace/trace-failure", path="<%s>" % name,
                context=name, message="the step failed to run (%s: %s)"
                % (type(e).__name__,
                   (str(e).splitlines() or ["?"])[0][:200])))
    by_sig: Dict[str, List[str]] = {}
    for name, sig in sigs.items():
        if name.startswith("predict[tier="):
            by_sig.setdefault(sig, []).append(name)
    for names in by_sig.values():
        if len(names) > 1:
            findings.append(Finding(
                rule="trace/retrace-unstable", path="<tier_grid>",
                context="tier_grid",
                message="distinct architectures exported to the SAME "
                        "program (%s): the architecture knob is dead"
                        % ", ".join(sorted(names))))
    return findings
