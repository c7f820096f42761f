"""The PyTorch port's slice as a whole against the JAX package, on the CPU.

* predict: uint8 images -> JAX `make_predict_fn(..., normalize="imagenet")`
  and the port's `predict` with the same converted weights: every
  detection scoring >= 0.1 on one side has a match on the other (same
  class, IoU >= 0.99, |score difference| <= 1e-3), both ways;
* evaluation: JAX `evaluate` and the port's `evaluate` on the same
  synthetic VOC fixture and weights give mAP within 1e-3 and matching
  per-image detections;
* launch sites: one forward at the flagship width calls the epilogue at
  20 sites, the residual tail at 17 and the peak test once; each of
  chip_smoke.py's other configurations (VARIANT_SITES) at its own counts,
  which chip_smoke.py's derivation (`bn_sites`) must reproduce;
* evaluation with `--nms soft-nms` against the JAX driver, mAP within
  1e-3;
* entry points: the default device is CUDA, and without a card they
  raise instead of running on the CPU; the CLI runs eval and the demo
  with --device cpu.
"""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.data import \
    make_synthetic_voc as jax_make_synthetic_voc
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu.predict import \
    make_predict_fn as jax_make_predict_fn
from real_time_helmet_detection_tpu.train import init_variables
from real_time_helmet_detection_tpu_torch import convert
from real_time_helmet_detection_tpu_torch.__main__ import main
from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.data.synthetic import \
    make_synthetic_voc
from real_time_helmet_detection_tpu_torch.evaluate import (evaluate,
                                                           load_eval_state)
from real_time_helmet_detection_tpu_torch.models.hourglass import \
    build_model
from real_time_helmet_detection_tpu_torch.ops import epilogue, peak, residual
from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

ARCH = dict(imsize=64, hourglass_inch=32, num_cls=2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (repo root: the configurations it runs)

# (epilogue sites, residual-tail sites) of one forward of each of
# chip_smoke.py's VARIANT_CONFIGS, by hand from models/hourglass.py: a
# block's BN'd convs are epilogue sites, except the tail conv of a
# residual or depthwise block whose activation the kernels take (a tail
# site); the PreLayer's 3 blocks and the neck's are ReLU; the hourglass
# has 13 blocks per stack.
VARIANT_SITES = {
    # ghost, 64 wide: 4 convs a block (2 ghost modules of 2), never a
    # fused tail: stem 1 + PreLayer 3 x 4 + hourglass 13 x 4 + neck 1 + 4
    "edge-arch": (70, 0),
    # residual, 2 stacks: stem 1 + 64->128 block (conv, projection) 2 +
    # 2 x 1, per stack hourglass 13 x 1 + neck 1 + 1; one tail a block
    "quality-arch": (1 + 2 + 2 + 2 * (13 + 2), 3 + 2 * (13 + 1)),
    # depthwise: 3 convs and the fused tail a block, + the projection
    "depthwise-128": (1 + 4 + 3 + 3 + 13 * 3 + 1 + 3, 3 + 13 + 1),
    # PReLU hourglass blocks are unfused (2 epilogue sites each); the
    # PreLayer's and the neck's ReLU blocks fuse; the neck conv is Mish
    "options": (1 + 2 + 1 + 1 + 13 * 2 + 1 + 1, 3 + 1),
}


def load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _iou(box, boxes):
    """IoU with corners put in order (random weights emit inverted boxes)."""
    box = np.concatenate([np.minimum(box[:2], box[2:]),
                          np.maximum(box[:2], box[2:])])
    boxes = np.concatenate([np.minimum(boxes[:, :2], boxes[:, 2:]),
                            np.maximum(boxes[:, :2], boxes[:, 2:])], 1)
    wh = np.clip(np.minimum(box[2:], boxes[:, 2:])
                 - np.maximum(box[:2], boxes[:, :2]), 0, None)
    inter = wh[:, 0] * wh[:, 1]
    union = (np.prod(box[2:] - box[:2]) + np.prod(boxes[:, 2:] - boxes[:, :2],
                                                  axis=1) - inter)
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def assert_detections_match(a, b, min_score=0.1):
    """a, b: per-image (boxes, classes, scores) of valid detections."""
    checked = 0
    for (ab, ac, as_), (bb, bc, bs) in zip(a, b):
        sel = bs >= min_score - 1e-3
        bb, bc, bs = bb[sel], bc[sel], bs[sel]
        for box, c, s in zip(ab, ac, as_):
            if s < min_score:
                continue
            checked += 1
            close = (_iou(box, bb) >= 0.99) | (
                np.abs(bb - box).max(axis=1, initial=0) <= 1e-2)
            hit = (bc == c) & (np.abs(bs - s) <= 1e-3) & close
            assert hit.any(), (box, c, s)
    return checked


def rows(dets):
    boxes, classes, scores, valid = (np.asarray(x) for x in dets)
    return [(boxes[i][valid[i]], classes[i][valid[i]], scores[i][valid[i]])
            for i in range(boxes.shape[0])]


def bn_scaled(variables, seed):
    """Random BN state with scales in [0.2, 0.6]: O(1) logits, so scores
    spread instead of saturating (see test_torch_model.py)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for coll in ("params", "batch_stats"):
        for path, v in convert.flatten_tree(variables[coll]).items():
            leaf = path.rsplit("/", 1)[-1]
            v = np.asarray(v)
            if "BatchNorm" in path:
                lo, hi = {"scale": (0.2, 0.6), "var": (0.5, 1.5)}.get(
                    leaf, (-0.2, 0.2))
                v = rng.uniform(lo, hi, v.shape).astype(np.float32)
            flat["%s/%s" % (coll, path)] = v
    return convert.unflatten_tree(flat)


@pytest.mark.parametrize("ns", [1, 2])
def test_predict_matches_jax(ns):
    jcfg = JaxConfig(num_stack=ns, **ARCH)
    jmodel = jax_build(jcfg)
    params, stats = init_variables(jmodel, jax.random.key(ns), 64)
    variables = bn_scaled(jax.device_get({"params": params,
                                          "batch_stats": stats}), ns)
    images = np.random.default_rng(ns).integers(0, 256, (2, 64, 64, 3),
                                                dtype=np.uint8)
    want = jax.device_get(jax_make_predict_fn(jmodel, jcfg,
                                              normalize="imagenet")(
        variables, jnp.asarray(images)))
    cfg = Config(device="cpu", num_stack=ns, **ARCH)
    model = convert.load_into(build_model(cfg), variables)
    got = make_predict_fn(model, cfg, normalize="imagenet",
                          device="cpu")(images)
    assert got.boxes.shape == (2, ns * 100, 4)
    assert got.classes.dtype == torch.int32 and got.valid.dtype == torch.bool
    n = assert_detections_match(rows(got), rows(want)) \
        + assert_detections_match(rows(want), rows(got))
    assert n > 0
    # the uint8 path normalizes on the device exactly as a float caller
    from real_time_helmet_detection_tpu_torch.utils import normalize_image
    normed = np.stack([normalize_image(im) for im in images])
    again = make_predict_fn(model, cfg, device="cpu")(normed)
    assert_detections_match(rows(again), rows(got))


def test_flagship_forward_launch_sites(monkeypatch):
    """The flagship architecture calls the epilogue at 20 sites, the
    residual tail at 17 and the peak test once per forward (the counts
    chip_smoke.py holds the CUDA launch counters to)."""
    calls = {"bn_act": 0, "bn_add_act": 0, "peak_scores": 0}

    def counting(mod, name):
        real = getattr(mod, name)

        def wrapper(*args, **kw):
            calls[name] += 1
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    counting(epilogue, "bn_act")
    counting(residual, "bn_add_act")
    counting(peak, "peak_scores")
    cfg = Config(device="cpu", imsize=64)  # 128 channels, 1 stack
    predict = make_predict_fn(load_eval_state(cfg), cfg, device="cpu")
    predict(np.zeros((1, 64, 64, 3), np.float32))
    assert calls == {"bn_act": 20, "bn_add_act": 17, "peak_scores": 1}
    assert epilogue.launches == residual.launches == peak.launches == 0


@pytest.mark.parametrize("name", list(VARIANT_SITES))
def test_variant_forward_launch_sites(monkeypatch, name):
    """Each of chip_smoke.py's configurations, at imsize 64 on the CPU:
    the epilogue, tail and peak calls of one predict equal VARIANT_SITES
    and chip_smoke.py's derived launch counts; no launch counter moves."""
    assert sorted(VARIANT_SITES) == sorted(chip_smoke.VARIANT_CONFIGS)
    calls = {"bn_act": 0, "bn_add_act": 0, "peak_scores": 0}

    def counting(mod, attr):
        real = getattr(mod, attr)

        def wrapper(*args, **kw):
            calls[attr] += 1
            return real(*args, **kw)
        monkeypatch.setattr(mod, attr, wrapper)

    counting(epilogue, "bn_act")
    counting(residual, "bn_add_act")
    counting(peak, "peak_scores")
    cfg = Config(device="cpu", imsize=64, **chip_smoke.VARIANT_CONFIGS[name])
    predict = make_predict_fn(load_eval_state(cfg), cfg, device="cpu")
    dets = predict(np.zeros((1, 64, 64, 3), np.float32))
    epi, tail = VARIANT_SITES[name]
    assert calls == {"bn_act": epi, "bn_add_act": tail, "peak_scores": 1}
    assert dets.boxes.shape == (1, cfg.num_stack * 100, 4)
    assert tuple(map(len, chip_smoke.bn_sites(cfg))) == (epi, tail)
    want = chip_smoke.expected_launches(cfg, "predict", torch.float32)
    assert (want["bn_act"], want["bn_act_vec"], want["bn_add_act"],
            want["peak_scores"]) == (epi, epi, tail, 1)
    assert epilogue.launches == residual.launches == peak.launches == 0


def test_synthetic_fixture_matches_jax_generator(tmp_path):
    a = make_synthetic_voc(str(tmp_path / "port"), num_train=2, num_test=3,
                           imsize=(96, 72), seed=4)
    b = jax_make_synthetic_voc(str(tmp_path / "jax"), num_train=2,
                               num_test=3, imsize=(96, 72), seed=4)
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert len(files) == 2 * 5 + 2
    for rel in files:
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            assert fa.read() == fb.read(), rel


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    return make_synthetic_voc(str(root), num_train=0, num_test=4,
                              imsize=(96, 72), seed=1)


def test_evaluate_matches_jax(voc, tmp_path):
    evaluate_both(voc, tmp_path)


def test_evaluate_soft_nms_matches_jax(voc, tmp_path):
    """The same with `--nms soft-nms` on both sides: the decayed scores are
    what the txt files and the mAP take."""
    evaluate_both(voc, tmp_path, nms="soft-nms")


def evaluate_both(voc, tmp_path, **extra):
    """JAX `evaluate` and the port's on the same fixture and weights: mAP
    and per-class AP within 1e-3, matching per-image detections."""
    from real_time_helmet_detection_tpu.evaluate import \
        evaluate as jax_evaluate
    common = dict(data=voc, batch_size=2, print_interval=1,
                  random_seed=7, **ARCH, **extra)
    jcfg = JaxConfig(save_path=str(tmp_path / "jax"), serve_buckets=[2],
                     num_workers=1, **common)
    jm = jax_evaluate(jcfg)
    # JAX `evaluate` seeds its weights from random_seed; the port loads
    # the same tree through the npz bridge
    params, stats = init_variables(jax_build(jcfg),
                                   jax.random.key(jcfg.random_seed), 64)
    npz = str(tmp_path / "w.npz")
    convert.save_npz(npz, jax.device_get({"params": params,
                                          "batch_stats": stats}))
    cfg = Config(device="cpu", save_path=str(tmp_path / "torch"),
                 model_load=npz, **common)
    m = evaluate(cfg)
    assert abs(m["map"] - jm["map"]) <= 1e-3
    for c in m["ap"]:
        assert abs(m["ap"][c] - jm["ap"][c]) <= 1e-3 or (
            np.isnan(m["ap"][c]) and np.isnan(jm["ap"][c]))
    got = load_pickle(str(tmp_path / "torch" / "prediction_results.pickle"))
    want = load_pickle(str(tmp_path / "jax" / "prediction_results.pickle"))
    assert sorted(got) == sorted(want) and len(got) == 4
    as_rows = lambda r: [(r[k]["box"], r[k]["cls"], r[k]["score"])
                         for k in sorted(r)]
    assert_detections_match(as_rows(got), as_rows(want))
    assert_detections_match(as_rows(want), as_rows(got))
    txt = sorted(os.listdir(tmp_path / "torch" / "results" / "txt"))
    assert txt == ["%06d.txt" % i for i in range(4)]


def test_default_device_entry_points_refuse_cpu_only_box(voc):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    cfg = Config(**ARCH)
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        load_eval_state(cfg)
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        make_predict_fn(model, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--data", voc, "--imsize", "64"])


def test_cli_eval_and_demo_on_cpu(voc, tmp_path, capsys):
    out = str(tmp_path / "out")
    main(["--data", voc, "--imsize", "64", "--hourglass-inch", "32",
          "--batch-size", "3", "--device", "cpu", "--save-path", out])
    printed = capsys.readouterr().out
    assert ": mAP " in printed
    assert os.path.exists(os.path.join(out, "prediction_results.pickle"))
    assert len(os.listdir(os.path.join(out, "results", "txt"))) == 4
    image = os.path.join(voc, "JPEGImages", "000000.jpg")
    main(["--data", image, "--imsize", "64", "--hourglass-inch", "32",
          "--device", "cpu", "--save-path", out])
    assert os.path.getsize(os.path.join(out, "image.png")) > 0
