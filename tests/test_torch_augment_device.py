"""The port's device augmentation and GT encoder (`--device-augment`)
against the JAX package's, on the CPU.

The port draws its augmentation parameters from a torch generator (JAX's
threefry stream cannot be reproduced), so the deterministic half is held
to JAX on JAX's own draw: `jax.random`'s `sample_params` output, as
numpy, goes through both packages.

* `build_matrix` within rtol 1e-6, atol 1e-4 of JAX's (float32
  products of up to four 3x3 matrices; observed below 3e-5).
* `warp_image` given each package's own matrices: where the two floors
  of the source coordinate agree, within 2e-2 grey levels (observed
  7.7e-3: the two matrices' source coordinates differ by up to 3e-5 px,
  times grey steps of up to 255 a pixel in the random canvas);
  elsewhere (a coordinate an ulp from an integer) at most 1 in 1000
  pixels, each within 1 grey level.
* The box transform and filter: boxes atol 1e-3 (observed 3e-5), the
  validity mask identical.
* `augment_encode_batch` on JAX's draw: the image by the warp's rule,
  boxes and validity as above; `heat` atol 1e-5, `offset`/`size` atol
  1e-4 and `mask` identical wherever the boxes' centre cells agree.
* `encode_boxes_device` against `encode_boxes_jax` on the same boxes,
  including boxes on one centre cell (the last valid one wins) and no
  valid box: heat atol 1e-6, offset/size/mask exact; with no box at all
  (which `encode_boxes_jax` cannot take) against JAX's numpy
  `encode_boxes`, exactly.
* `pick_target` gives JAX's bucket sequence (JAX's runner, its step
  builder stubbed to record the bucket); `sample_params` is reproducible
  and within its ranges.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.data import augment_device as jad
from real_time_helmet_detection_tpu.ops.encode import \
    encode_boxes as jax_encode_boxes
from real_time_helmet_detection_tpu.ops.encode import encode_boxes_jax
from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.data import augment_device as pad
from real_time_helmet_detection_tpu_torch.ops.encode import \
    encode_boxes_device
from real_time_helmet_detection_tpu_torch.train import pick_target
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

B, CANVAS = 4, 96


def jax_draw(seed, b=B):
    """JAX's parameters of one step, as numpy."""
    return {k: np.asarray(v) for k, v in jad.sample_params(
        jax.random.key(seed), b).items()}


def jax_matrix(params, i, w, h, target):
    return np.asarray(jad.build_matrix(
        {k: jnp.asarray(v[i]) for k, v in params.items()}, float(w),
        float(h), float(target)))


def scene(seed, b=B, n=6, canvas=CANVAS):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, canvas, canvas, 3), dtype=np.uint8)
    xy = rng.uniform(0, canvas - 20, (b, n, 2))
    wh = rng.uniform(4, 40, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.integers(0, 2, (b, n)).astype(np.int32)
    valid = rng.random((b, n)) < 0.8
    return images, boxes, labels, valid


def warp_rule(got, want, sx_got, sx_want):
    """The warp's equality rule (module docstring)."""
    agree = np.all(np.floor(sx_got) == np.floor(sx_want), axis=0)
    diff = np.abs(got - want).max(axis=-1)
    assert diff[agree].max(initial=0) <= 2e-2, diff[agree].max()
    off = ~agree
    assert off.mean() <= 1e-3, off.mean()
    assert diff[off].max(initial=0) <= 1.0, diff[off].max()


def source_coords(inv, target):
    g = np.arange(target, dtype=np.float32) + 0.5
    px, py = np.meshgrid(g, g)
    sx = inv[0, 0] * px + inv[0, 1] * py + inv[0, 2] - 0.5
    sy = inv[1, 0] * px + inv[1, 1] * py + inv[1, 2] - 0.5
    return np.stack([sx, sy])


def test_build_matrix_matches_jax():
    params = jax_draw(0)
    got = pad.build_matrix(params, 120.0, 90.0, 64.0).numpy()
    for i in range(B):
        np.testing.assert_allclose(got[i], jax_matrix(params, i, 120, 90,
                                                      64), rtol=1e-6,
                                   atol=1e-4)


@pytest.mark.parametrize("target", [64, 128])
def test_warp_matches_jax(target):
    params = jax_draw(1)
    images = scene(2)[0].astype(np.float32)
    m = pad.build_matrix(params, CANVAS, CANVAS, target)
    inv = torch.linalg.inv(m)
    got = pad.warp_image(torch.from_numpy(images), inv, target).numpy()
    for i in range(B):
        jm = jax_matrix(params, i, CANVAS, CANVAS, target)
        want = np.asarray(jad.warp_image(jnp.asarray(images[i]),
                                         jnp.asarray(jm), target))
        warp_rule(got[i], want, source_coords(inv[i].numpy(), target),
                  source_coords(np.linalg.inv(jm), target))


def test_box_transform_and_filter_match_jax():
    params = jax_draw(3)
    _, boxes, _, valid = scene(4)
    m = pad.build_matrix(params, CANVAS, CANVAS, 64)
    got = pad.transform_boxes_device(torch.from_numpy(boxes), m)
    got_b, got_v = pad.filter_boxes_device(got, torch.from_numpy(valid),
                                           64.0)
    for i in range(B):
        jm = jnp.asarray(jax_matrix(params, i, CANVAS, CANVAS, 64))
        wb = jad.transform_boxes_jax(jnp.asarray(boxes[i]), jm)
        wb, wv = jad.filter_boxes_jax(wb, jnp.asarray(valid[i]), 64.0)
        np.testing.assert_allclose(got_b[i].numpy(), np.asarray(wb),
                                   atol=1e-3)
        np.testing.assert_array_equal(got_v[i].numpy(), np.asarray(wv))


@pytest.mark.parametrize("normalized", [False, True])
def test_augment_encode_batch_on_jax_draw(normalized):
    key = jax.random.key(5)
    images, boxes, labels, valid = scene(6)
    target = 64
    want = jax.device_get(jad.augment_encode_batch(
        key, jnp.asarray(images, jnp.float32), jnp.asarray(boxes),
        jnp.asarray(labels), jnp.asarray(valid), target=target,
        normalized=normalized))
    params = {k: np.asarray(v) for k, v in
              jad.sample_params(key, B).items()}
    got = [t.numpy() for t in pad.augment_encode_batch(
        params, torch.from_numpy(images), torch.from_numpy(boxes),
        torch.from_numpy(labels), torch.from_numpy(valid), target=target,
        normalized=normalized)]
    m = pad.build_matrix(params, CANVAS, CANVAS, target)
    inv = torch.linalg.inv(m).numpy()
    for i in range(B):
        jm = jax_matrix(params, i, CANVAS, CANVAS, target)
        warp_rule(got[0][i], want[0][i], source_coords(inv[i], target),
                  source_coords(np.linalg.inv(jm), target))
    np.testing.assert_allclose(got[5], want[5], atol=1e-3)
    np.testing.assert_array_equal(got[6], want[6])
    # the maps, wherever every valid box's centre cell agrees
    cells = lambda b: np.floor((b[..., :2] + b[..., 2:]) / 8.0)  # noqa: E731
    same = np.all((cells(got[5]) == cells(want[5])) | ~got[6][..., None],
                  axis=(1, 2))
    assert same.all()
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], atol=1e-4)
    np.testing.assert_allclose(got[3], want[3], atol=1e-4)
    np.testing.assert_array_equal(got[4], want[4])


def encode_case(name):
    rng = np.random.default_rng(7)
    n = 8
    boxes = rng.uniform(0, 50, (n, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(2, 14, (n, 2))
    labels = rng.integers(0, 2, n).astype(np.int32)
    valid = np.ones(n, bool)
    if name == "duplicate-centres":
        # three boxes on one centre cell; the middle one invalid: the
        # last VALID one (index 5) wins the point scatter
        boxes[3:6] = [[10, 10, 20, 20], [11, 11, 19, 19], [12, 9, 18, 21]]
        valid[4] = False
        valid[6:] = False
    elif name == "no-valid":
        valid[:] = False
    elif name == "empty":
        boxes, labels, valid = boxes[:0], labels[:0], valid[:0]
    return boxes, labels, valid


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("name", ["random", "duplicate-centres", "no-valid",
                                  "empty"])
def test_encode_boxes_device_matches_jax(name, normalized):
    boxes, labels, valid = encode_case(name)
    if name == "empty":
        want = jax_encode_boxes(boxes, labels, (64, 64),
                                normalized=normalized)
    else:
        want = jax.device_get(encode_boxes_jax(
            jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid),
            height=16, width=16, normalized=normalized))
    got = encode_boxes_device(
        torch.from_numpy(boxes)[None], torch.from_numpy(labels)[None],
        torch.from_numpy(valid)[None], height=16, width=16,
        normalized=normalized)
    np.testing.assert_allclose(got[0][0].numpy(), want[0], atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g[0].numpy(), w)
    if name == "duplicate-centres" and not normalized:
        cell = (3, 3)  # the centre cell of boxes 3-5 at scale 4
        assert got[3][0][cell].item() == 1.0
        np.testing.assert_array_equal(
            got[2][0][cell].numpy(), (boxes[5, 2:] - boxes[5, :2]) / 4.0)


def test_pick_target_is_jax_sequence(monkeypatch):
    """JAX's runner with its fused-step builder stubbed to record the
    bucket of each call: the port's `pick_target` gives the same
    sequence."""
    from real_time_helmet_detection_tpu import train as jax_train
    from real_time_helmet_detection_tpu.data import pipeline as jax_pipe
    from real_time_helmet_detection_tpu.parallel import make_mesh
    seen = []

    def stub(model, tx, cfg, mesh, target, distill=None):
        def run(*args):
            seen.append(target)
            return args[0], {}
        return run

    monkeypatch.setattr(jax_train, "make_device_train_step", stub)
    kw = dict(device_augment=True, multiscale_flag=True,
              multiscale=[64, 256, 32], random_seed=5, batch_size=1)
    runner = jax_train.make_step_runner(JaxConfig(**kw), make_mesh(1),
                                        None, None)
    z = np.zeros((1, 0, 0, 0), np.float32)
    batch = jax_pipe.Batch(np.zeros((1, 8, 8, 3), np.uint8), z, z, z, z,
                           np.zeros((1, 4, 4), np.float32),
                           np.zeros((1, 4), np.int32),
                           np.zeros((1, 4), bool), [])
    steps = list(range(40)) + [1000, 123456]
    for s in steps:
        runner(None, batch, s)
    cfg = Config(device="cpu", **kw)
    assert [pick_target(cfg, s) for s in steps] == seen
    assert len(set(seen)) > 1


def test_sample_params_reproducible_and_in_range():
    kw = dict(crop_percent=(0.0, 0.1), color_multiply=(1.2, 1.5),
              translate_percent=0.1, affine_scale=(0.5, 1.5))
    a = pad.sample_params(pad.step_generator(9, 3), 64, **kw)
    b = pad.sample_params(pad.step_generator(9, 3), 64, **kw)
    c = pad.sample_params(pad.step_generator(9, 4), 64, **kw)
    for k in pad.PARAM_KEYS:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["scale"], c["scale"])
    assert ((a["scale"] >= 0.5) & (a["scale"] <= 1.5)).all()
    assert (a["translate"].abs() <= 0.1).all()
    assert ((a["crop"] >= 0) & (a["crop"] <= 0.1)).all()
    assert ((a["color"] >= 1.2) & (a["color"] <= 1.5)).all()
    assert a["flip"].dtype == torch.bool and 0 < int(a["flip"].sum()) < 64
    # a rank's share of the global draw is its rows of it
    rows = pad.rows_of(a, 16, 32)
    assert torch.equal(rows["crop"], a["crop"][16:32])
