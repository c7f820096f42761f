"""The training-log snapshots and the remaining readers and fixtures of
the port against the JAX package's, on the CPU.

* `utils.blend_heatmap` (and `denormalize_image`, `make_grid`,
  `arr2pil`, `load_pickle`) give JAX's arrays; the PNG the port writes
  (`save_png`) holds JAX's pixels.
* `train.make_snapshot_fn` on the verify recipe's small model (1 stack,
  width 32, 64^2, BN state drawn by `bn_scaled`) matches JAX's
  `make_snapshot_fn` on the same weights within atol 2e-5 (float32
  sigmoids of logits that agree to the eval path's 1e-4 bound,
  test_torch_model.py), leaves the model in train mode with its BN
  buffers, and runs no grad.
* A two-step CPU train writes `training_log/e{epoch}_i{i}_{gt,pred}.png`
  at JAX's print steps, and its checkpoints are bit-equal to the same
  run's without a `training_log/` (no snapshot); `get_config` makes the
  directory for a train run as JAX's does.
* `compute_map_from_txt` gives JAX's result on the same txt directory.
* The "scenes" fixture writes JAX's bytes for the same seed.
"""

import os
import signal

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from real_time_helmet_detection_tpu import metrics as jax_metrics
from real_time_helmet_detection_tpu import utils as jax_utils
from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.config import \
    get_config as jax_get_config
from real_time_helmet_detection_tpu.data.synthetic import \
    make_synthetic_voc as jax_make_voc
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu.train import (init_variables,
                                                  make_snapshot_fn as
                                                  jax_snapshot_fn)
from real_time_helmet_detection_tpu_torch import convert, metrics, utils
from real_time_helmet_detection_tpu_torch.config import Config, get_config
from real_time_helmet_detection_tpu_torch.data.synthetic import \
    make_synthetic_voc
from real_time_helmet_detection_tpu_torch.models.hourglass import \
    build_model
from real_time_helmet_detection_tpu_torch.train import (load_checkpoint,
                                                        make_snapshot_fn,
                                                        train)
from test_torch_predict import bn_scaled
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

TIMEOUT_S = 180
SNAPSHOT_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _hard_timeout():
    def _fire(signum, frame):
        raise RuntimeError("train-log test exceeded the %ds hard timeout"
                           % TIMEOUT_S)

    old = signal.signal(signal.SIGALRM, _fire)
    signal.alarm(TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def arrays(seed=0, b=5, h=48, w=40, hm=(12, 10), cls=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, 3)).astype(np.float32),
            rng.uniform(-0.2, 1.2, (b, *hm, cls)).astype(np.float32))


@pytest.mark.parametrize("pretrained", ["imagenet", "scratch", None])
def test_blend_heatmap_png_matches_jax(tmp_path, pretrained):
    image, heat = arrays()
    ours = utils.blend_heatmap(image, heat, pretrained)
    theirs = jax_utils.blend_heatmap(image, heat, pretrained)
    utils.save_png(str(tmp_path / "ours.png"), ours)
    theirs.save(str(tmp_path / "theirs.png"))
    a = np.asarray(Image.open(tmp_path / "ours.png"))
    b = np.asarray(Image.open(tmp_path / "theirs.png"))
    assert a.shape == b.shape == (2 * 50 + 2, 3 * 42 + 2, 3)
    np.testing.assert_array_equal(a, b)
    one = utils.blend_heatmap(image[:1], heat[0, ..., :1], pretrained)
    np.testing.assert_array_equal(np.asarray(one), np.asarray(
        jax_utils.blend_heatmap(image[:1], heat[0, ..., :1], pretrained)))


def test_image_helpers_match_jax(tmp_path):
    image, _ = arrays(seed=1, b=3)
    for pre in ("imagenet", None):
        np.testing.assert_array_equal(
            utils.denormalize_image(image[0], pre),
            jax_utils.denormalize_image(image[0], pre))
        np.testing.assert_array_equal(np.asarray(utils.arr2pil(image, pre)),
                                      np.asarray(jax_utils.arr2pil(image,
                                                                   pre)))
        np.testing.assert_array_equal(
            np.asarray(utils.arr2pil(image[0, ..., :1], pre)),
            np.asarray(jax_utils.arr2pil(image[0, ..., :1], pre)))
    np.testing.assert_array_equal(utils.make_grid(image, pad=3),
                                  jax_utils.make_grid(image, pad=3))
    utils.save_pickle(str(tmp_path / "p.pickle"), {"a": image})
    np.testing.assert_array_equal(
        utils.load_pickle(str(tmp_path / "p.pickle"))["a"],
        jax_utils.load_pickle(str(tmp_path / "p.pickle"))["a"])


SMALL = dict(num_stack=1, hourglass_inch=32, num_cls=2, imsize=64)


def test_snapshot_matches_jax_and_leaves_the_model_alone():
    jcfg = JaxConfig(**SMALL)
    jmodel = jax_build(jcfg)
    params, stats = init_variables(jmodel, jax.random.key(0), 64)
    variables = bn_scaled(jax.device_get({"params": params,
                                          "batch_stats": stats}), 2)
    images = np.random.default_rng(3).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax_snapshot_fn(jmodel, jcfg)(
        variables["params"], variables["batch_stats"], images))
    cfg = Config(device="cpu", **SMALL)
    model = convert.load_into(build_model(cfg), variables)
    model.train()
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    rng = torch.get_rng_state()
    got = make_snapshot_fn(model, cfg)(images)
    assert model.training and not got.requires_grad
    assert got.shape == want.shape == (2, 16, 16, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SNAPSHOT_ATOL)
    assert torch.equal(rng, torch.get_rng_state())
    for k, v in model.named_buffers():
        assert torch.equal(v, buffers[k]), k
    torch.testing.assert_close(make_snapshot_fn(model, cfg)(
        torch.from_numpy(images)), got, rtol=0, atol=0)


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    return make_synthetic_voc(str(tmp_path_factory.mktemp("voc")),
                              num_train=8, num_test=4, seed=0)


def train_cfg(voc, out):
    from real_time_helmet_detection_tpu_torch.config import parse_args
    return parse_args([
        "--train-flag", "--data", voc, "--device", "cpu",
        "--hourglass-inch", "8", "--stem-width", "8", "--batch-size", "4",
        "--multiscale", "32", "64", "32", "--print-interval", "1",
        "--num-workers", "2", "--end-epoch", "1", "--hang-warn-seconds",
        "0", "--save-path", out])


def test_snapshots_change_nothing_the_run_saves(voc, tmp_path):
    """Two steps with snapshots (the directory `get_config` makes) and
    two without: the same checkpoint, bit for bit."""
    with_log, without = str(tmp_path / "log"), str(tmp_path / "nolog")
    get_config(["--train-flag", "--save-path", with_log])
    assert os.path.isdir(os.path.join(with_log, "training_log"))
    train(train_cfg(voc, with_log))
    train(train_cfg(voc, without))
    assert sorted(os.listdir(os.path.join(with_log, "training_log"))) == [
        "e0_i%d_%s.png" % (i, k) for i in (0, 1) for k in ("gt", "pred")]
    assert not os.path.exists(os.path.join(without, "training_log"))
    a = load_checkpoint(os.path.join(with_log, "check_point_1"))
    b = load_checkpoint(os.path.join(without, "check_point_1"))
    assert a["step"] == b["step"] == 2 and a["loss_log"] == b["loss_log"]
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    for k, v in a["optimizer"]["state"].items():
        for name, t in v.items():
            assert torch.equal(t, b["optimizer"]["state"][k][name])


def test_get_config_makes_training_log_as_jax_does(tmp_path):
    for name, get in (("port", get_config), ("jax", jax_get_config)):
        out = str(tmp_path / name)
        get(["--train-flag", "--save-path", out])
        assert os.path.isdir(os.path.join(out, "training_log"))
        ev = str(tmp_path / (name + "_eval"))
        get(["--save-path", ev])
        assert not os.path.exists(os.path.join(ev, "training_log"))


def test_compute_map_from_txt_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    gt_b, gt_l = {}, {}
    for i in range(6):
        img = "%06d" % i
        n = int(rng.integers(0, 4))
        xy = rng.uniform(0, 80, (n, 2))
        gt_b[img] = np.concatenate([xy, xy + rng.uniform(8, 30, (n, 2))],
                                   1).astype(np.float32)
        gt_l[img] = rng.integers(0, 2, n).astype(np.int32)
        if i == 5:
            continue  # no txt file: no detections
        m = int(rng.integers(0, 6))
        boxes = np.concatenate([gt_b[img], rng.uniform(0, 100, (m, 4))])
        boxes = boxes + rng.normal(0, 2, boxes.shape)
        labels = np.concatenate([gt_l[img], rng.integers(0, 2, m)])
        scores = rng.uniform(0, 1, len(boxes))
        metrics.write_detection_txt(str(tmp_path), img, boxes, labels,
                                    scores)
    ours = metrics.compute_map_from_txt(str(tmp_path), gt_b, gt_l)
    theirs = jax_metrics.compute_map_from_txt(str(tmp_path), gt_b, gt_l)
    assert ours == theirs and ours["map"] > 0
    for path in sorted(os.listdir(tmp_path)):
        for x, y in zip(metrics.read_detection_txt(str(tmp_path / path)),
                        jax_metrics.read_detection_txt(str(tmp_path /
                                                           path))):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype


@pytest.mark.parametrize("kw", [
    dict(seed=3), dict(seed=7, head_div_range=(12.0, 4.0),
                       helmeted_rate=0.5, max_objects=8)])
def test_scenes_fixture_is_jax_s_bytes(tmp_path, kw):
    a = make_synthetic_voc(str(tmp_path / "a"), num_train=3, num_test=2,
                           imsize=(128, 96), style="scenes", **kw)
    b = jax_make_voc(str(tmp_path / "b"), num_train=3, num_test=2,
                     imsize=(128, 96), style="scenes", **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert len(files) == 5 * 2 + 2
    for rel in files:
        with open(os.path.join(a, rel), "rb") as f, \
                open(os.path.join(b, rel), "rb") as g:
            assert f.read() == g.read(), rel
    with pytest.raises(ValueError, match="style"):
        make_synthetic_voc(str(tmp_path / "c"), style="crowds")
