"""Host<->device transfer audit (graftlint layer 4): the committed
manifest of every registered entry point's interface to the card.

Port of ref real_time_helmet_detection_tpu/analysis/transfer_audit.py:97
(`measure_entry`; `ENTRY_POINTS` :264-295, `gate_manifest`, `BYTES_TOL`
:62, `counting_device_get`). An entry point is a device program between
two host boundaries: its host inputs go up (`h2d_fresh`), it runs on the
card against state that stays there (`resident`: the weights it reads,
the parameters, buffers and optimizer state a train step updates in
place), and its output leaves come back (`d2h`). `measure_entry` runs
the program once on the CPU at the audit's tiny shapes and lists:

* the output leaves fetched to the host, with shape, dtype and bytes;
* the host inputs against the resident tensors (leaves and bytes);
* the host-sync ops the program dispatches (`trace_audit.HOST_SYNC_OPS`,
  recorded by a dispatch mode: `.item()`, a data-dependent shape).

`gate_manifest` holds a measurement to the committed
`transfer_manifest.json` (schema `transfer-manifest-v1`): leaf counts
exact, bytes within `BYTES_TOL` (2%); each delta is an `xfer/*` finding
(the baseline stays empty), an improvement is printed and adopted with
`graftlint --write-manifest`. On the card, `chip_smoke.py`'s `analysis`
phase runs the same entries under `torch.profiler` and holds the
`Memcpy HtoD`/`DtoH` records to the manifest: one copy per leaf.

`counting_syncs()` is the runtime twin of JAX's `counting_device_get`:
it counts `.item()`, `.cpu()`, `.tolist()`, `.numpy()` and
`torch.cuda.synchronize()` calls, so the "no extra D2H" pins of the
tests share one implementation.

The registered entries are JAX's that the port has: the train step
(plain, telemetry, sentinel, bf16-compute, distill, fwd int8), predict,
the cascade summary predict, the stream delta summary and tile predict,
serve b1/b2/b4 and `calibrate_scales`. JAX's `predict_chain` (bench.py's
donating scan of predicts) and `train_step_scanned[block-fuse]` (a JAX
formulation switch) have no counterpart in the port: it has no bench
chain yet, and one BN formulation. The train step's fetch is the loss
flush's: the losses (and the sentinel's and telemetry's scalars) stacked
into one row, one copy for a whole `--print-interval` window.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from . import Finding
from .trace_audit import HOST_SYNC_OPS, OpRecorder, state_tensors

SCHEMA = "transfer-manifest-v1"
BYTES_TOL = 0.02  # bytes within 2%; leaf counts are exact

MANIFEST_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "transfer_manifest.json")
MANIFEST_RELPATH = "real_time_helmet_detection_tpu_torch/analysis/" \
                   "transfer_manifest.json"


class Entry:
    """One registered entry point, built on `device`: `host` (numpy
    arrays the program takes), `program(*device_inputs)` -> a tuple of
    device tensors, `resident` (the tensors that stay on the card)."""

    def __init__(self, program: Callable, host: Sequence[np.ndarray],
                 resident: Sequence[torch.Tensor]):
        self.program = program
        self.host = tuple(host)
        self.resident = list(resident)

    def run(self, device) -> Tuple[torch.Tensor, ...]:
        """Upload the host inputs, run, return the device outputs."""
        dev = torch.device(device)
        return tuple(self.program(*(torch.from_numpy(np.ascontiguousarray(
            a)).to(dev) for a in self.host)))


def _side(leaves) -> Dict:
    return {"leaves": len(leaves),
            "bytes": int(sum(int(np.prod(t.shape)) * t.element_size()
                             if torch.is_tensor(t) else int(t.nbytes)
                             for t in leaves))}


def _spec(t: torch.Tensor) -> str:
    return "%s%s" % (str(t.dtype).replace("torch.", ""), list(t.shape))


def measure_entry(entry: Entry) -> Dict:
    """The entry's host<->device surface from one CPU run (see the
    module docstring)."""
    with OpRecorder() as rec:
        outs = entry.run("cpu")
    d2h = _side(outs)
    d2h["shapes"] = sorted(_spec(t) for t in outs)
    return {"d2h": d2h, "h2d_fresh": _side(entry.host),
            "resident": _side(entry.resident),
            "host_callbacks": len(rec.ops & set(HOST_SYNC_OPS))}


# ---------------------------------------------------------------------------
# the registered entry points (trace_audit's tiny shapes)


def _state(model, optimizer=None) -> List[torch.Tensor]:
    return list(state_tensors(model, optimizer).values())


def train_entry(mode: str = "none", device="cpu") -> Entry:
    """One host step of a train configuration and its loss flush: the
    batch goes up, the step runs (update on), its losses come back as
    `train_epoch`'s flush fetches them, one stacked row."""
    from ..ops.loss import LossLog
    from .trace_audit import tiny_train
    t = tiny_train(mode, device=device)
    t.optimizer.init_state()

    def program(*arrays):
        out = t.step(0, *arrays)
        keys = LossLog.KEYS + tuple(sorted(set(out) - set(LossLog.KEYS)))
        return (torch.stack([out[k].float() for k in keys]),)

    return Entry(program, t.batch, _state(t.model, t.optimizer))


def predict_entry(device="cpu", **kw) -> Entry:
    """A predict's body on its images (`trace_audit.tiny_predict`'s
    keywords): the images go up, the detections' leaves come back."""
    from .trace_audit import tiny_predict
    predict, images = tiny_predict(device=device, **kw)

    def program(x):
        with torch.inference_mode():
            return tuple(predict.body(x))

    return Entry(program, (images,), _state(predict.model))


def serve_entry(bucket: int, device="cpu") -> Entry:
    """One serving bucket as the engine runs it (`predict.BucketRunner`:
    on a card, its CUDA graph's replay): the uint8 rows go up into the
    static input, the static outputs come back."""
    from ..predict import BucketRunner
    from .trace_audit import tiny_predict
    predict, images = tiny_predict(normalize="imagenet", batch=bucket,
                                   device=device)
    runner = BucketRunner(predict, bucket, images.shape[1:], torch.uint8)

    def program(x):
        runner.input.copy_(x)
        return tuple(runner.run())

    return Entry(program, (images,), _state(predict.model))


def delta_entry(grid: int = 2, device="cpu") -> Entry:
    """The stream session's tile summary of two uploaded frames."""
    from ..ops.delta import tile_delta_summary
    from .trace_audit import _TINY
    frame = np.zeros((grid * _TINY["imsize"], grid * _TINY["imsize"], 3),
                     np.uint8)
    return Entry(lambda p, c: (tile_delta_summary(p, c, grid),),
                 (frame, frame), ())


def calib_entry(device="cpu") -> Entry:
    """One calibration batch through the instrumented twin and the
    scales' one fetch (`ops.quant.calibrate_scales`, `read_scales`)."""
    from ..ops.quant import (load_twin, make_quant_model, quant_modules,
                             synthetic_calibration_batches)
    from .trace_audit import _BATCH, _TINY, tiny_config, tiny_model
    cfg = tiny_config(infer_dtype="int8")
    twin = make_quant_model(cfg, mode="calibrate")
    load_twin(twin, tiny_model(cfg).state_dict())
    twin = twin.to(device).eval()
    mods = list(quant_modules(twin).values())
    images = next(iter(synthetic_calibration_batches(_BATCH,
                                                     _TINY["imsize"])))

    @torch.no_grad()
    def program(x):
        twin(x)
        return (torch.stack([m.act_scale.detach().float().reshape(())
                             for m in mods]),)

    return Entry(program, (images,), _state(twin))


_RT = "real_time_helmet_detection_tpu_torch/"
_TRAIN_MODS = (_RT + "train.py", _RT + "models/", _RT + "optim.py",
               _RT + "ops/")
_PREDICT_MODS = (_RT + "predict.py", _RT + "models/", _RT + "ops/")
_SERVE_MODS = _PREDICT_MODS + (_RT + "serving/engine.py",)

# name -> (build(device) -> Entry, owning module prefixes for
# `graftlint --changed`)
ENTRY_POINTS: Dict[str, Tuple[Callable, Tuple[str, ...]]] = {
    "train_step": (lambda d: train_entry("none", d), _TRAIN_MODS),
    "train_step[telemetry]": (
        lambda d: train_entry("telemetry", d),
        _TRAIN_MODS + (_RT + "obs/telemetry.py",)),
    "train_step[sentinel]": (lambda d: train_entry("sentinel", d),
                             _TRAIN_MODS),
    "train_step[param=bf16-compute]": (
        lambda d: train_entry("param=bf16-compute", d), _TRAIN_MODS),
    "train_step[distill]": (lambda d: train_entry("distill", d),
                            _TRAIN_MODS),
    "train_step[fwd=int8]": (lambda d: train_entry("fwd=int8", d),
                             _TRAIN_MODS),
    "predict": (lambda d: predict_entry(d), _PREDICT_MODS),
    "predict_cascade_summary[tier=edge]": (
        lambda d: predict_entry(d, arch=dict(variant="ghost", num_stack=1,
                                             hourglass_inch=8,
                                             stem_width=8),
                                cascade_summary=True),
        _PREDICT_MODS + (_RT + "ops/decode.py", _RT + "serving/fleet.py")),
    "stream_delta_summary[grid=2]": (
        lambda d: delta_entry(2, d),
        (_RT + "ops/delta.py", _RT + "serving/streams.py")),
    "stream_tile_predict[b=2]": (
        lambda d: serve_entry(2, d),
        _SERVE_MODS + (_RT + "serving/streams.py",)),
    "serve_predict[b=1]": (lambda d: serve_entry(1, d), _SERVE_MODS),
    "serve_predict[b=2]": (lambda d: serve_entry(2, d), _SERVE_MODS),
    "serve_predict[b=4]": (lambda d: serve_entry(4, d), _SERVE_MODS),
    "calibrate_scales": (lambda d: calib_entry(d),
                         (_RT + "ops/quant.py", _RT + "models/")),
}


def entries_for_changed(changed: Sequence[str]) -> Set[str]:
    """The entries whose owning modules a changed-file list touches."""
    return {name for name, (_, mods) in ENTRY_POINTS.items()
            if any(path.startswith(mods) for path in changed)}


def measure_repo_entry_points(only: Optional[Set[str]] = None
                              ) -> Dict[str, Dict]:
    """name -> measurement, or {"error": ...}: an entry that no longer
    builds cannot pass the gate silently."""
    out: Dict[str, Dict] = {}
    for name, (build, _) in ENTRY_POINTS.items():
        if only is not None and name not in only:
            continue
        try:
            out[name] = measure_entry(build("cpu"))
        except Exception as e:  # noqa: BLE001 — the failure is the finding
            out[name] = {"error": "%s: %s" % (
                type(e).__name__, (str(e).splitlines() or ["?"])[0][:200])}
    return out


# ---------------------------------------------------------------------------
# the manifest: load, gate, write


def load_manifest(path: Optional[str] = None) -> Dict:
    """The committed manifest, or an empty one (then every entry fails as
    `xfer/unknown-entry`)."""
    path = path or MANIFEST_PATH
    if not os.path.exists(path):
        return {"schema": SCHEMA, "entries": {}}
    with open(path) as f:
        data = json.load(f)
    if data.get("schema") != SCHEMA:
        raise ValueError("%s is not a %s manifest (schema=%r)"
                         % (path, SCHEMA, data.get("schema")))
    return data


def _finding(rule: str, entry: str, message: str) -> Finding:
    return Finding(rule=rule, path=MANIFEST_RELPATH, context=entry,
                   message=message)


def gate_manifest(measured: Dict[str, Dict], manifest: Dict,
                  tol: float = BYTES_TOL) -> Dict:
    """The ratchet: {"findings": [Finding], "improved": [str], "stale":
    [str]}. Growth fails (leaf counts exact, bytes beyond `tol`);
    improvements and stale entries are reported for --write-manifest."""
    findings: List[Finding] = []
    improved: List[str] = []
    entries = manifest.get("entries", {})
    for name in sorted(measured):
        m = measured[name]
        if "error" in m:
            findings.append(_finding(
                "xfer/entry-unmeasurable", name,
                "entry %r failed to measure (%s)" % (name, m["error"])))
            continue
        if name not in entries:
            findings.append(_finding(
                "xfer/unknown-entry", name,
                "entry %r has no committed transfer budget — adopt it "
                "with `graftlint --write-manifest`" % name))
            continue
        want = entries[name]
        md, wd = m["d2h"], want["d2h"]
        if md["leaves"] > wd["leaves"]:
            findings.append(_finding(
                "xfer/extra-fetch-leaf", name,
                "%s fetches %d output leaves (budget %d): a new D2H copy "
                "(measured %s vs manifest %s)"
                % (name, md["leaves"], wd["leaves"], md["shapes"],
                   wd.get("shapes", []))))
        elif md["leaves"] < wd["leaves"]:
            improved.append("%s: d2h leaves %d -> %d"
                            % (name, wd["leaves"], md["leaves"]))
        mh, wh = m["h2d_fresh"], want["h2d_fresh"]
        if mh["leaves"] > wh["leaves"] \
                or m["resident"]["leaves"] < want["resident"]["leaves"]:
            findings.append(_finding(
                "xfer/undonated-input", name,
                "%s input split drifted: fresh H2D %d leaves (budget %d), "
                "resident %d (budget %d) — state that stayed on the card "
                "now goes up every call"
                % (name, mh["leaves"], wh["leaves"],
                   m["resident"]["leaves"], want["resident"]["leaves"])))
        elif mh["leaves"] < wh["leaves"]:
            improved.append("%s: fresh H2D leaves %d -> %d"
                            % (name, wh["leaves"], mh["leaves"]))
        if md["bytes"] > wd["bytes"] * (1.0 + tol):
            findings.append(_finding(
                "xfer/d2h-bytes-grew", name,
                "%s D2H grew %d -> %d bytes (tolerance %.0f%%)"
                % (name, wd["bytes"], md["bytes"], 100.0 * tol)))
        elif md["bytes"] < wd["bytes"] * (1.0 - tol):
            improved.append("%s: d2h bytes %d -> %d"
                            % (name, wd["bytes"], md["bytes"]))
        if mh["bytes"] > wh["bytes"] * (1.0 + tol):
            findings.append(_finding(
                "xfer/h2d-bytes-grew", name,
                "%s fresh H2D grew %d -> %d bytes"
                % (name, wh["bytes"], mh["bytes"])))
        if m["host_callbacks"] > want.get("host_callbacks", 0):
            findings.append(_finding(
                "xfer/host-callback-grew", name,
                "%s gained a host sync op (%d vs budget %d)"
                % (name, m["host_callbacks"],
                   want.get("host_callbacks", 0))))
    stale = sorted(k for k in entries if k not in measured) \
        if set(measured) >= set(ENTRY_POINTS) else []
    return {"findings": findings, "improved": improved, "stale": stale}


def write_manifest(measured: Dict[str, Dict],
                   path: Optional[str] = None) -> str:
    """Adopt the measurement as the committed budget (atomically);
    refuses an unmeasurable entry."""
    from ..utils import save_json
    path = path or MANIFEST_PATH
    bad = sorted(n for n, m in measured.items() if "error" in m)
    if bad:
        raise ValueError("refusing to write a manifest with unmeasurable "
                         "entries: %s" % ", ".join(bad))
    save_json(path, {"schema": SCHEMA, "entries": measured}, indent=1,
              sort_keys=True)
    return path


def audit_transfers(only: Optional[Set[str]] = None,
                    manifest_path: Optional[str] = None) -> Dict:
    """Measure (every entry, or `only`) and gate: layer 4's whole run."""
    measured = measure_repo_entry_points(only=only)
    res = gate_manifest(measured, load_manifest(manifest_path))
    res["measured"] = measured
    return res


# ---------------------------------------------------------------------------
# the runtime twin: counted host syncs


class SyncCounter:
    """The host fetches and syncs seen while `counting_syncs` is active:
    `count` in all, `calls` as (kind, shape) pairs."""

    def __init__(self):
        self.calls: List[Tuple[str, Tuple[int, ...]]] = []

    @property
    def count(self) -> int:
        return len(self.calls)


_FETCH_METHODS = ("item", "cpu", "tolist", "numpy")


@contextlib.contextmanager
def counting_syncs():
    """Count every `Tensor.item/.cpu/.tolist/.numpy` call and every
    `torch.cuda.synchronize()` under the context (nested calls count
    once: `.tolist()` does not count the `.item()`s it makes); the real
    methods are back on exit, also when the body raises."""
    counter = SyncCounter()
    real = {name: getattr(torch.Tensor, name) for name in _FETCH_METHODS}
    real_sync = torch.cuda.synchronize
    depth = [0]

    def wrap(name, fn):
        def counted(self, *args, **kwargs):
            if not depth[0]:
                counter.calls.append((name, tuple(self.shape)))
            depth[0] += 1
            try:
                return fn(self, *args, **kwargs)
            finally:
                depth[0] -= 1
        return counted

    def sync(*args, **kwargs):
        counter.calls.append(("synchronize", ()))
        return real_sync(*args, **kwargs)

    for name, fn in real.items():
        setattr(torch.Tensor, name, wrap(name, fn))
    torch.cuda.synchronize = sync
    try:
        yield counter
    finally:
        for name, fn in real.items():
            setattr(torch.Tensor, name, fn)
        torch.cuda.synchronize = real_sync
