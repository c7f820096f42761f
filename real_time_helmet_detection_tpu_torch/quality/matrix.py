"""The quality matrix's command line (ref scripts/quality_matrix.py:1011
`main`, :119 `run_tiers`, :451 `run_cascade`, :704 `run_streams`):

    python -m real_time_helmet_detection_tpu_torch.quality.matrix \\
        [--tiers | --cascade | --streams] [--smoke] [--epochs N]
        [--train N] [--test N] [--only rows] [--device cuda|cpu]
        [--out-dir DIR] [--work-dir DIR] [--width-scale K]

Each row trains with the train loop a user calls (`train.train`) and
scores held-out mAP with the eval a user calls (`evaluate.evaluate`, or
the predict it serves through for the sweeps), so every kernel of those
paths runs at trained weights:

* no mode: the quality levers of the flagship recipe on the "scenes"
  fixture (base, base+soft, base+ema, base+pool5, base+int8, stack2,
  multiscale, multiscale+soft, stack2+multiscale, stack2+multiscale+soft);
* `--tiers`: the latency tiers' Pareto rows. The quality tier trains
  first and becomes the teacher; the edge tier trains from scratch and
  with `--distill` (`distill_vs_scratch_dmap`); the throughput tier
  distills and is scored through int8 PTQ (`map_bf16`,
  `delta_map_int8_vs_bf16`). Each tier row has the counting model and
  served b1 latency of `quality.cost` at the preset's real width;
* `--cascade`: the escalation threshold of edge-first serving, from the
  edge tier's confidence and both tiers' detections (`quality.sweeps`);
* `--streams`: the tile-skip threshold of delta-gated video, on the video
  fixture of `quality.fixture`.

The modes share the fixture and the trainings (a training with its
TRAIN_DONE marker is reused). Records keep JAX's schemas and keys
(quality-matrix-v2, cascade-calibration-v1, stream-calibration-v1);
`tier_meta.platform` / `platform` is "gpu" on the card, and each record
adds "device": the platform, the card's name and power limit. A full run
on the card writes them to the package's `calibration/` directory, where
`config.cascade_overrides` / `stream_overrides` read them; a `--smoke`
or CPU run writes beside its trainings, so that no smoke record can
become a calibration. Nothing is written under the repo's `artifacts/`:
the JAX package's loaders read that. It runs on `cuda` unless `--device
cpu` is given and raises without a card. Under `--smoke` the sizes are
JAX's smoke sizes: 64^2, the "blocks" fixture, widths / 4
(`--width-scale`)."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np

from .. import config
from ..config import TIER_PRESETS, Config, save_config
from ..data.voc import boxes_from_voc_dict
from ..obs.spans import maybe_tracer
from ..runtime.heartbeat import maybe_job_heartbeat
from ..utils import atomic_write_bytes, save_json
from . import fixture, sweeps
from .cost import predict_stats

# where `config._calibrated` looks for the port's own records
CALIBRATION_DIR = os.path.join(os.path.dirname(os.path.abspath(
    config.__file__)), config.CALIBRATION_DIR)
LEVER_ROWS = ("base", "base+soft", "base+ema", "base+pool5", "base+int8",
              "stack2", "multiscale", "multiscale+soft", "stack2+multiscale",
              "stack2+multiscale+soft")
TIER_ROWS = ("quality", "edge_scratch", "edge", "throughput")
# a finished training is reused only when its snapshot has these values
REUSE_FIELDS = ("data", "variant", "num_stack", "hourglass_inch",
                "stem_width", "batch_size", "end_epoch", "lr", "amp",
                "multiscale_flag", "multiscale", "ema_decay", "distill")


def log(msg: str) -> None:
    print("[qmatrix] %s" % msg, file=sys.stderr, flush=True)


def card_identity(device) -> Dict:
    """{"platform", "name", "power_limit"} of the device a run used:
    `torch.cuda.get_device_name` and nvidia-smi's power limit on the
    card; "cpu" and None on the CPU."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "power_limit": None}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = None
    return {"platform": "gpu", "name": torch.cuda.get_device_name(device),
            "power_limit": limit or None}


def latest_ckpt(save: str) -> str:
    """The newest complete checkpoint under `save`; raises if none."""
    path = config.find_latest_checkpoint(save)
    if path is None:
        raise RuntimeError("no checkpoint under %s" % save)
    return path


class Run:
    """One invocation's sizes, paths, device and flight recorder."""

    def __init__(self, args):
        from ..predict import resolve_device
        self.device = resolve_device(args.device)
        self.smoke = smoke = args.smoke
        self.levers = not (args.tiers or args.cascade or args.streams)
        if self.levers:
            self.epochs = args.epochs or (2 if smoke else 45)
            self.n_train = args.train or (8 if smoke else 640)
            self.n_test = args.test or (4 if smoke else 96)
            # the levers score the hard fixture at every size
            self.style, self.max_objects = "scenes", 12
        else:
            self.epochs = args.epochs or 45
            self.n_train = args.train or (128 if smoke else 640)
            self.n_test = args.test or (32 if smoke else 96)
            # smoke scores the easy fixture: at 64^2 the scenes style is
            # below the trainable floor of a smoke budget (JAX's probe:
            # mAP 0.0 at 20 epochs vs 0.20 on blocks at 45); the tiers'
            # order is the smoke signal, absolute numbers the card's
            self.style = "blocks" if smoke else "scenes"
            self.max_objects = 4 if smoke else 12
        self.imsize = 64 if smoke else 512
        self.batch = 4 if smoke else 16
        self.wscale = args.width_scale or (4 if smoke else 1)
        self.archs = {
            name: {"variant": p["variant"], "num_stack": p["num_stack"],
                   "width": max(8, p["hourglass_inch"] // self.wscale)}
            for name, p in TIER_PRESETS.items()}
        self.work = args.work_dir or os.path.join(tempfile.gettempdir(),
                                                  "qmatrix_torch")
        self.data_root = os.path.join(self.work, "voc_%s_%s_%d" % (
            self.style, "levers" if self.levers else "tiers", self.imsize))
        self.train_root = os.path.join(
            self.work, ("levers" if self.levers else "tiers")
            + ("_smoke" if smoke else ""))
        calibrates = not smoke and self.device.type == "cuda"
        self.out_dir = args.out_dir or (CALIBRATION_DIR if calibrates
                                        else self.train_root)
        self.identity = card_identity(self.device)
        self.hb = maybe_job_heartbeat()
        self.tracer = maybe_tracer()

    def dataset(self) -> None:
        """The fixture; trainings on an older one are dropped with it."""
        if fixture.ensure_dataset(self.data_root, self.n_train, self.n_test,
                                  self.imsize, self.style, self.max_objects,
                                  log=log) \
                and os.path.isdir(self.train_root):
            shutil.rmtree(self.train_root)

    def save_of(self, row: str) -> str:
        return os.path.join(self.train_root, row)

    def fixture_meta(self) -> Dict:
        return {"style": self.style, "imsize": self.imsize,
                "n_train": self.n_train, "n_test": self.n_test,
                "epochs": self.epochs, "width_scale": self.wscale}

    # -------------------------------------------------------- configs
    def tier_config(self, name: str, save: str, **kw) -> Config:
        """JAX's tier training recipe: b16, Adam 5e-4, milestones at 50%
        and 90% of the epochs, --amp with the input augmented and cached
        on the device, at the run's width of `name`."""
        a = self.archs[name]
        base = dict(
            device=str(self.device), train_flag=True, data=self.data_root,
            save_path=save, variant=a["variant"], num_stack=a["num_stack"],
            hourglass_inch=a["width"], stem_width=min(128, a["width"]),
            num_cls=2, batch_size=self.batch, amp=True, optim="adam",
            lr=5e-4, lr_milestone=[int(self.epochs * 0.5),
                                   int(self.epochs * 0.9)],
            end_epoch=self.epochs, device_augment=True, cache_device=True,
            multiscale_flag=False, multiscale=[self.imsize, self.imsize, 64],
            keep_ckpt=2, ckpt_interval=max(1, self.epochs // 2),
            hang_warn_seconds=1200, num_workers=4, print_interval=10,
            summary=False)
        base.update(kw)
        return Config(**base)

    def eval_config(self, name: str, save: str, **kw) -> Config:
        """The held-out eval of `name`'s newest checkpoint under `save`
        (float32 unless `kw` says otherwise, as JAX's)."""
        a = self.archs[name]
        base = dict(
            device=str(self.device), train_flag=False, data=self.data_root,
            save_path=save, model_load=latest_ckpt(save),
            variant=a["variant"], num_stack=a["num_stack"],
            hourglass_inch=a["width"], stem_width=min(128, a["width"]),
            num_cls=2, batch_size=self.batch, imsize=self.imsize, topk=100,
            conf_th=0.01, nms="nms", nms_th=0.5, num_workers=4)
        base.update(kw)
        return Config(**base)

    def lever_config(self, save: str, train_mode: bool, **kw) -> Config:
        """The flagship recipe of the lever rows (the reference README's
        b16, Adam 5e-4, milestones at 50% / 90%, on the device-cached
        input), and its eval."""
        inch = 16 if self.smoke else 128
        if train_mode:
            base = dict(
                device=str(self.device), train_flag=True,
                data=self.data_root, save_path=save, num_stack=1,
                hourglass_inch=inch, num_cls=2, batch_size=self.batch,
                amp=True, optim="adam", lr=5e-4,
                lr_milestone=[int(self.epochs * 0.5),
                              int(self.epochs * 0.9)],
                end_epoch=self.epochs, device_augment=True,
                cache_device=True, multiscale_flag=False,
                multiscale=[self.imsize, self.imsize, 64], ema_decay=0.998,
                keep_ckpt=2, ckpt_interval=5, auto_resume=2,
                hang_warn_seconds=1200, num_workers=8, print_interval=10)
        else:
            base = dict(
                device=str(self.device), train_flag=False,
                data=self.data_root, save_path=save,
                model_load=latest_ckpt(save), num_stack=1,
                hourglass_inch=inch, num_cls=2, batch_size=self.batch,
                imsize=self.imsize, topk=100, conf_th=0.01, nms="nms",
                nms_th=0.5, num_workers=8)
        base.update(kw)
        return Config(**base)

    # ---------------------------------------------------------- steps
    def train(self, save: str, cfg: Config) -> float:
        """Train into `save` unless its TRAIN_DONE marker is whole; the
        training's wall seconds. A partial dir is cleared and trained
        anew: only a training that returned writes the marker."""
        from ..train import train
        marker = os.path.join(save, "TRAIN_DONE")
        try:
            with open(marker) as f:
                wall = float(f.read().strip().split("=")[1])
            with open(os.path.join(save, "argument.json")) as f:
                snap = json.load(f)
        except (OSError, ValueError, IndexError):
            pass
        else:
            want = dataclasses.asdict(cfg)
            if all(snap.get(k) == want[k] for k in REUSE_FIELDS):
                log("training %s already complete (marker)" % save)
                return wall
            log("training %s was of another recipe; retraining" % save)
        if os.path.isdir(save) and os.listdir(save):
            log("partial training at %s; clearing and retraining" % save)
            shutil.rmtree(save)
        os.makedirs(save, exist_ok=True)
        with self.tracer.span("train-tier", save=save) as sp:
            train(cfg)
        # the snapshot lets --distill restore the teacher's architecture
        save_config(cfg, save)
        atomic_write_bytes(marker, ("wall_s=%.1f\n" % sp.dur_s).encode())
        log("training %s done in %.0fs" % (save, sp.dur_s))
        self.hb.beat("trained %s" % os.path.basename(save))
        return sp.dur_s

    def flush(self, name: str, record: Dict) -> str:
        """Write `record` to `<out_dir>/<name>` atomically; beats the job
        heartbeat."""
        path = os.path.join(self.out_dir, name)
        os.makedirs(self.out_dir, exist_ok=True)
        save_json(path, record, indent=1)
        self.hb.beat("flushed %s" % name)
        return path

    def held_out(self):
        return fixture.held_out(self.data_root, self.imsize, self.batch)

    def predict_of(self, name: str, save: str, **kw):
        """(cfg, predict) of `name`'s newest checkpoint under `save` on
        the run's device (the eval's float32 configuration)."""
        from ..evaluate import load_eval_state
        from ..predict import make_predict_fn
        cfg = self.eval_config(name, save)
        model = load_eval_state(cfg, self.device)
        return cfg, make_predict_fn(model, cfg, normalize=cfg.pretrained,
                                    device=self.device, **kw)


def host_rows(predict, images) -> list:
    """One b1 predict of each image, every row fetched in one copy per
    field after the last predict (JAX's one batched fetch), as numpy."""
    import torch
    pend = [predict(img[None]) for img in images]
    fields = [torch.cat([d[i] for d in pend]).cpu().numpy()
              for i in range(len(pend[0]))]
    return [type(pend[0])(*(f[k] for f in fields))
            for k in range(len(pend))]


def serve_requests(run: Run) -> int:
    """Served b1 requests timed per tier (JAX's smoke chain is 4 long)."""
    return 4 if run.smoke else 100


# ------------------------------------------------------------------ tiers
def run_tiers(run: Run, only) -> Dict:
    """The tiers' Pareto rows (see the module docstring)."""
    from ..evaluate import evaluate
    run.dataset()
    out_name = "quality_matrix.json"
    tier_meta = {"platform": run.identity["platform"], "smoke": run.smoke,
                 "imsize": run.imsize, "fixture": run.style,
                 "n_train": run.n_train, "n_test": run.n_test,
                 "epochs": run.epochs, "width_scale": run.wscale}
    results: Dict = {"schema": "quality-matrix-v2", "tier_meta": tier_meta,
                     "tiers": {}}
    try:
        with open(os.path.join(run.out_dir, out_name)) as f:
            prior = json.load(f)
    except (OSError, json.JSONDecodeError):
        prior = {}
    for k in ("fixture", "imsize", "n_train", "n_test", "epochs", "rows"):
        if k in prior:
            results[k] = prior[k]  # the lever rows ride along
    if prior.get("tier_meta") == tier_meta:
        results["tiers"] = prior.get("tiers", {})
    results["device"] = run.identity

    def want(row):
        return (only is None or row in only) and row not in results["tiers"]

    def record(row, rec):
        results["tiers"][row] = rec
        log("tier %s: %s" % (row, rec))
        run.flush(out_name, results)

    def scored(name, save, **kw):
        return evaluate(run.eval_config(name, save, **kw))

    def tier_row(name, m, wall, **extra):
        p = TIER_PRESETS[name]
        rec = {"arch": {"variant": p["variant"], "num_stack": p["num_stack"],
                        "width": p["hourglass_inch"]},
               "map_arch": dict(run.archs[name]), "preset": p,
               "mAP": round(float(m["map"]), 4)}
        rec.update(extra)
        rec["eval_wall_s"] = round(wall, 1)
        rec.update(predict_stats(name, run.imsize, str(run.device),
                                 serve_requests(run)))
        return rec

    qsave = run.save_of("quality")
    teacher = None
    if any(want(r) for r in TIER_ROWS):
        run.train(qsave, run.tier_config("quality", qsave))
        teacher = latest_ckpt(qsave)
    if want("quality"):
        with run.tracer.span("eval-tier", tier="quality") as sp:
            m = scored("quality", qsave, nms="soft-nms")
        record("quality", tier_row("quality", m, sp.dur_s, distilled=False))
    es_save = run.save_of("edge_scratch")
    if want("edge_scratch"):
        run.train(es_save, run.tier_config("edge", es_save))
        m = scored("edge", es_save)
        record("edge_scratch", {"arch": dict(run.archs["edge"]),
                                "mAP": round(float(m["map"]), 4),
                                "distilled": False})
    if want("edge"):
        ed_save = run.save_of("edge")
        run.train(ed_save, run.tier_config("edge", ed_save, distill=teacher))
        with run.tracer.span("eval-tier", tier="edge") as sp:
            m = scored("edge", ed_save)
        rec = tier_row("edge", m, sp.dur_s, distilled=True, teacher=teacher)
        sc = results["tiers"].get("edge_scratch")
        if sc:
            rec["distill_vs_scratch_dmap"] = round(rec["mAP"] - sc["mAP"], 4)
            log("edge distill vs scratch dmAP: %+.4f"
                % rec["distill_vs_scratch_dmap"])
        record("edge", rec)
    if want("throughput"):
        th_save = run.save_of("throughput")
        run.train(th_save, run.tier_config("throughput", th_save,
                                           distill=teacher))
        with run.tracer.span("eval-tier", tier="throughput") as sp:
            m_f = scored("throughput", th_save)
            m_q = scored("throughput", th_save, infer_dtype="int8")
        record("throughput", tier_row(
            "throughput", m_q, sp.dur_s,
            map_bf16=round(float(m_f["map"]), 4),
            delta_map_int8_vs_bf16=round(float(m_q["map"])
                                         - float(m_f["map"]), 4),
            infer_dtype="int8", distilled=True, teacher=teacher))
    frontier = [{"tier": name, "mAP": r["mAP"],
                 "serve_wire_ms_b1": r["serve_wire_ms_b1"],
                 "predict_gflops": r.get("predict_gflops"),
                 "predict_bytes": r.get("predict_bytes"),
                 "params_m": r.get("params_m")}
                for name in ("edge", "throughput", "quality")
                for r in [results["tiers"].get(name)]
                if r and "serve_wire_ms_b1" in r]
    if frontier:
        results["tier_pareto"] = sorted(frontier,
                                        key=lambda r: r["serve_wire_ms_b1"])
    path = run.flush(out_name, results)
    print(json.dumps({"tiers": {k: {kk: vv for kk, vv in v.items()
                                    if kk != "preset"}
                                for k, v in results["tiers"].items()},
                      "tier_pareto": results.get("tier_pareto"),
                      "out": path}), flush=True)
    return results


# ---------------------------------------------------------------- cascade
def run_cascade(run: Run) -> Dict:
    """The cascade's escalation threshold: each held-out image scored once
    by the edge tier (from scratch: the serving edge tier) with its
    confidence and once by the quality tier, then `sweeps.cascade_sweep`."""
    run.dataset()
    qsave, esave = run.save_of("quality"), run.save_of("edge_scratch")
    run.train(qsave, run.tier_config("quality", qsave))
    run.train(esave, run.tier_config("edge", esave))
    images, infos = run.held_out()
    log("scoring %d held-out images per tier" % len(images))
    _, edge_predict = run.predict_of("edge", esave, cascade_summary=True)
    _, quality_predict = run.predict_of("quality", qsave)
    edge_rows = host_rows(edge_predict, images)
    run.hb.beat("edge tier scored")
    quality_rows = host_rows(quality_predict, images)
    run.hb.beat("quality tier scored")
    gt_boxes, gt_labels, dets = {}, {}, {}
    scale = float(run.imsize)
    for k, (info, er, qr) in enumerate(zip(infos, edge_rows, quality_rows)):
        iid = fixture.image_id(info, k)
        ow, oh = fixture.origin_size(info)
        gt_boxes[iid], gt_labels[iid] = boxes_from_voc_dict(info)
        resc = np.array([ow / scale, oh / scale, ow / scale, oh / scale],
                        np.float32)
        dets[iid] = {"edge": sweeps.host_row(er, resc),
                     "quality": sweeps.host_row(qr, resc),
                     "confidence": float(er.confidence)}
    sw = sweeps.cascade_sweep(gt_boxes, gt_labels, dets, log=log)
    run.hb.beat("threshold sweep done")
    out = {"schema": "cascade-calibration-v1",
           "platform": run.identity["platform"], "smoke": run.smoke,
           "fixture": run.fixture_meta(),
           "tiers": {"edge": dict(run.archs["edge"]),
                     "quality": dict(run.archs["quality"])}}
    out.update(sw)
    out["device"] = run.identity
    path = run.flush("cascade.json", out)
    sel = out["selected"]
    log("selected threshold %.4f (escalation %.0f%%, blended mAP %.4f) -> %s"
        % (sel["threshold"], 100 * sel["escalation_rate"],
           sel["blended_mAP"], path))
    print(json.dumps({"tool": "quality_matrix", "cascade": True,
                      "all_edge_mAP": out["all_edge_mAP"],
                      "all_quality_mAP": out["all_quality_mAP"],
                      "selected": sel, "sweep_points": len(out["sweep"]),
                      "out": path}), flush=True)
    return out


# ---------------------------------------------------------------- streams
GRID = 2
REDUNDANCY = 0.75
NOISE = 2


def run_streams(run: Run, frames: Optional[int] = None,
                seqs: Optional[int] = None) -> Dict:
    """The streams' tile-skip threshold: every tile of the video fixture
    scored once by the quality tier, every consecutive-frame delta summary
    taken once (`ops.delta`, on the run's device), then
    `sweeps.stream_sweep` replays the session cache offline."""
    from ..ops.delta import make_delta_fn, tile_origins
    run.dataset()
    T = frames or (8 if run.smoke else 16)
    n_seq = seqs or (8 if run.smoke else 16)
    qsave = run.save_of("quality")
    run.train(qsave, run.tier_config("quality", qsave))
    _, predict = run.predict_of("quality", qsave)
    images, infos = run.held_out()
    tiles = GRID * GRID
    log("synthesizing %d streams x %d frames from %d held-out tiles"
        % (n_seq, T, len(images)))
    seq_idx, noisy = fixture.video_fixture(images, n_seq, T, tiles,
                                           REDUNDANCY, NOISE)
    keys = sorted(noisy)
    preds = dict(zip(keys, host_rows(predict, [noisy[k] for k in keys])))
    run.hb.beat("tile predictions scored")
    fshape = (GRID * run.imsize, GRID * run.imsize, 3)
    origins = tile_origins(fshape, GRID)
    delta_fn = make_delta_fn(GRID, device=run.device)
    deltas = {}
    for s in range(n_seq):
        prev = delta_fn.upload(fixture.assemble_frame(noisy, s, 0, GRID))
        for f in range(1, T):
            cur = delta_fn.upload(fixture.assemble_frame(noisy, s, f, GRID))
            deltas[(s, f)] = delta_fn(prev, cur)
            prev = cur
    run.hb.beat("delta summaries scored")
    gt_boxes, gt_labels = fixture.frame_ground_truth(infos, seq_idx,
                                                     origins, run.imsize)
    sw = sweeps.stream_sweep(preds, deltas, gt_boxes, gt_labels, origins,
                             n_seq, T, log=log)
    run.hb.beat("threshold sweep done")
    meta = run.fixture_meta()
    meta.update(tile_grid=GRID, frames=T, sequences=n_seq,
                redundancy=REDUNDANCY, noise=NOISE)
    out = {"schema": "stream-calibration-v1",
           "platform": run.identity["platform"], "smoke": run.smoke,
           "fixture": meta, "arch": dict(run.archs["quality"])}
    out.update(sw)
    out["device"] = run.identity
    path = run.flush("streams.json", out)
    sel = out["selected"]
    log("selected threshold %.4f (skip %.0f%%, blended video mAP %.4f) -> %s"
        % (sel["threshold"], 100 * sel["tile_skip_rate"],
           sel["blended_video_mAP"], path))
    print(json.dumps({"tool": "quality_matrix", "streams": True,
                      "full_video_mAP": out["full_video_mAP"],
                      "selected": sel, "sweep_points": len(out["sweep"]),
                      "out": path}), flush=True)
    return out


# ----------------------------------------------------------------- levers
def run_levers(run: Run, only) -> Dict:
    """The quality levers of the flagship recipe (see the module
    docstring); rows merge into quality_matrix.json after each eval, and
    a rerun skips the rows it has."""
    from ..evaluate import evaluate
    run.dataset()
    out_name = "quality_matrix.json"
    results: Dict = {"fixture": "scenes", "imsize": run.imsize,
                     "n_train": run.n_train, "n_test": run.n_test,
                     "epochs": run.epochs, "rows": {}}
    try:
        with open(os.path.join(run.out_dir, out_name)) as f:
            prior = json.load(f)
    except (OSError, json.JSONDecodeError):
        prior = {}
    if (prior.get("n_train"), prior.get("epochs")) == (run.n_train,
                                                       run.epochs):
        results["rows"] = prior.get("rows", {})
    for k in ("schema", "tier_meta", "tiers", "tier_pareto"):
        if k in prior:
            results[k] = prior[k]  # the tier rows ride along
    results["device"] = run.identity

    def want(row):
        return (only is None or row in only) and row not in results["rows"]

    def record(row, m, t0, save, **extra):
        rec = {"mAP": round(float(m["map"]), 4),
               "ap_hat": round(float(m["ap"].get(0, float("nan"))), 4),
               "ap_person": round(float(m["ap"].get(1, float("nan"))), 4),
               "wall_s": round(time.time() - t0, 1), "save": save}
        rec.update(extra)
        results["rows"][row] = rec
        log("row %s: %s" % (row, rec))
        run.flush(out_name, results)

    def scored(row, save, extra=None, **kw):
        t0 = time.time()
        m = evaluate(run.lever_config(save, False, **kw))
        record(row, m, t0, save, **(extra or {}))
        return m

    base = run.save_of("base")
    if any(want(r) for r in LEVER_ROWS[:5]):
        run.train(base, run.lever_config(base, True))
    if want("base"):
        scored("base", base)
    if want("base+soft"):
        scored("base+soft", base, nms="soft-nms")
    if want("base+ema"):
        scored("base+ema", base, ema_eval=True, ema_decay=0.998)
    if want("base+pool5"):
        scored("base+pool5", base, pool_size=5)
    if want("base+int8"):
        # the same checkpoint through the int8 twin: quantization must
        # buy speed, not quality
        t0 = time.time()
        m = evaluate(run.lever_config(base, False, infer_dtype="int8"))
        extra = {"infer_dtype": "int8"}
        if "base" in results["rows"]:
            extra["delta_map_vs_bf16"] = round(
                float(m["map"]) - results["rows"]["base"]["mAP"], 4)
        record("base+int8", m, t0, base, **extra)
    if want("stack2"):
        save = run.save_of("stack2")
        t0 = time.time()
        run.train(save, run.lever_config(save, True, num_stack=2))
        m = evaluate(run.lever_config(save, False, num_stack=2))
        record("stack2", m, t0, save)
    ms_kw = dict(multiscale_flag=True, prewarm=True,
                 multiscale=[64, 128, 64] if run.smoke else [384, 576, 64])
    for name, stacks in (("multiscale", 1), ("stack2+multiscale", 2)):
        save = run.save_of(name.replace("+", "_"))
        if not (want(name) or want(name + "+soft")):
            continue
        wall = run.train(save, run.lever_config(save, True,
                                                num_stack=stacks, **ms_kw))
        if want(name):
            scored(name, save, extra={"train_wall_s": wall},
                   num_stack=stacks)
        if want(name + "+soft"):
            scored(name + "+soft", save, num_stack=stacks, nms="soft-nms")
    run.flush(out_name, results)
    print(json.dumps(results), flush=True)
    return results


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m real_time_helmet_detection_tpu_torch.quality.matrix",
        description=__doc__.splitlines()[0])
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--tiers", action="store_true",
                      help="the latency tiers' Pareto rows")
    mode.add_argument("--cascade", action="store_true",
                      help="calibrate the cascade's escalation threshold")
    mode.add_argument("--streams", action="store_true",
                      help="calibrate the streams' tile-skip threshold")
    p.add_argument("--smoke", action="store_true",
                   help="JAX's smoke sizes: 64^2, blocks, widths / 4")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--train", type=int, default=None,
                   help="training images of the fixture")
    p.add_argument("--test", type=int, default=None,
                   help="held-out images of the fixture")
    p.add_argument("--frames", type=int, default=None,
                   help="--streams: frames of each video (8 smoke, 16)")
    p.add_argument("--seqs", type=int, default=None,
                   help="--streams: videos (8 smoke, 16)")
    p.add_argument("--width-scale", type=int, default=None,
                   help="divide every tier width by this (4 smoke, 1)")
    p.add_argument("--only", default=None,
                   help="comma-separated rows to run (levers, --tiers)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--out-dir", default=None,
                   help="records' directory (default: the package's "
                        "calibration/ for a full run on the card, else "
                        "beside the trainings)")
    p.add_argument("--work-dir", default=None,
                   help="fixture and trainings (default: "
                        "$TMPDIR/qmatrix_torch)")
    return p


def main(argv=None) -> Dict:
    args = build_parser().parse_args(argv)
    run = Run(args)
    only = set(args.only.split(",")) if args.only else None
    if args.streams:
        return run_streams(run, args.frames, args.seqs)
    if args.cascade:
        return run_cascade(run)
    if args.tiers:
        return run_tiers(run, only)
    return run_levers(run, only)


if __name__ == "__main__":
    main()
