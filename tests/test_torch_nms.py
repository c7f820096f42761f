"""The port's soft-NMS and maxpool NMS, and predict's three `--nms` modes,
against the JAX package on the CPU.

* `soft_nms_mask` (batched over images) against JAX `soft_nms_mask` per
  image on the seeded clustered boxes of the JAX package's own oracle
  tests (tests/test_nms.py:132-182): keep masks identical, decayed scores
  within 1e-6;
* `maxpool_nms_mask` against JAX `maxpool_nms_mask` on
  `_clustered_boxes` (tests/test_nms.py:184), both of its regimes: keep
  masks identical;
* `make_predict_fn` with `--nms nms | soft-nms | maxpool` on both sides,
  the network replaced by the same fixed logits, so the comparison is of
  decode and suppression: boxes, classes and the valid mask identical,
  scores within 1e-6 (each side takes its own library's sigmoid, which
  may differ in the last bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.ops.nms import \
    maxpool_nms_mask as jax_maxpool_nms_mask
from real_time_helmet_detection_tpu.ops.nms import \
    soft_nms_mask as jax_soft_nms_mask
from real_time_helmet_detection_tpu.predict import \
    make_predict_fn as jax_make_predict_fn
from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.ops import nms
from real_time_helmet_detection_tpu_torch.predict import make_predict_fn

from test_nms import _clustered_boxes
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)


def oracle_boxes(seed, n=40):
    """The clustered boxes of tests/test_nms.py:139-145."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(20, 80, (8, 2))
    xy = centers[rng.randint(0, 8, n)] + rng.uniform(-8, 8, (n, 2))
    wh = rng.uniform(10, 30, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return boxes, rng.uniform(0.05, 1.0, n).astype(np.float32)


def masked_boxes():
    """The half-invalid set of tests/test_nms.py:163-169."""
    rng = np.random.RandomState(7)
    n = 24
    xy = rng.uniform(10, 60, (n, 2))
    wh = rng.uniform(15, 40, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.uniform(0.05, 1.0, n).astype(np.float32)
    return boxes, scores, rng.rand(n) < 0.6


@pytest.mark.parametrize("case", ["oracle", "masked"])
def test_soft_nms_matches_jax(case):
    """Observed: decayed scores max abs difference 6.0e-8 (oracle), 1.9e-9
    (masked); every keep mask identical."""
    if case == "oracle":
        sets = [oracle_boxes(seed) for seed in range(4)]
        boxes = np.stack([b for b, _ in sets])
        scores = np.stack([s for _, s in sets])
        valid = np.ones(scores.shape, bool)
        th = 0.3
    else:
        b, s, v = masked_boxes()
        boxes, scores, valid, th = b[None], s[None], v[None], 0.2
    keep, new = nms.soft_nms_mask(torch.from_numpy(boxes),
                                  torch.from_numpy(scores),
                                  torch.from_numpy(valid), sigma=0.5,
                                  score_th=th)
    assert keep.dtype == torch.bool and new.dtype == torch.float32
    for i in range(len(boxes)):
        wkeep, wnew = jax_soft_nms_mask(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
            jnp.asarray(valid[i]), sigma=0.5, score_th=th)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(wkeep))
        np.testing.assert_allclose(new[i].numpy(), np.asarray(wnew), rtol=0,
                                   atol=1e-6)
    assert 0 < int(keep.sum()) < keep.numel()  # some decayed below th


def test_maxpool_nms_matches_jax():
    """12 images (seeds 0-5 of both regimes of the JAX agreement-rate
    test) in one batched call: every keep mask identical, no box on an
    octave or cell boundary rounding apart."""
    sets = [_clustered_boxes(s, 48, 12, 4, 40, 60) for s in range(6)] \
        + [_clustered_boxes(s, 48, 12, 10, 40, 70) for s in range(6)]
    boxes = np.stack([b for b, _ in sets])
    scores = np.stack([s for _, s in sets])
    valid = np.random.default_rng(0).uniform(size=scores.shape) < 0.9
    keep = nms.maxpool_nms_mask(torch.from_numpy(boxes),
                                torch.from_numpy(scores),
                                torch.from_numpy(valid), extent=512.0)
    for i in range(len(sets)):
        want = np.asarray(jax_maxpool_nms_mask(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
            jnp.asarray(valid[i]), extent=512.0))
        np.testing.assert_array_equal(keep[i].numpy(), want,
                                      err_msg="image %d" % i)
    assert not bool((keep & ~torch.from_numpy(valid)).any())
    assert 0 < int(keep.sum()) < int(valid.sum())


class FixedLogits(torch.nn.Module):
    """A stand-in network: the same logits whatever the images."""

    def __init__(self, logits):
        super().__init__()
        self.logits = torch.from_numpy(logits)

    def forward(self, images):
        return self.logits


@pytest.mark.parametrize("mode", ["nms", "soft-nms", "maxpool"])
def test_predict_nms_modes_match_jax(mode):
    """Fixed (2, 2, 16, 16, 6) logits (2 images, 2 stacks, 64^2) through
    both predict functions: boxes, classes and valid identical, scores
    within 1e-6 (observed 0 for nms and maxpool, 6.0e-8 for soft-nms);
    soft-NMS's decayed scores replace the scores, maxpool keeps them. The
    JAX stand-in takes the logits as its parameter, so XLA does not fold
    the whole suppression into constants at compile time."""
    import flax.linen as fnn

    rng = np.random.default_rng(3)
    logits = rng.normal(0, 2, (2, 2, 16, 16, 6)).astype(np.float32)
    logits[..., 4:] = rng.uniform(1, 6, (2, 2, 16, 16, 2))  # box sizes
    kw = dict(num_stack=2, imsize=64, topk=30, conf_th=0.05, nms=mode)

    class JaxFixed(fnn.Module):
        @fnn.compact
        def __call__(self, images, train=False):
            return self.param("logits", lambda _: jnp.zeros(logits.shape))

    images = np.zeros((2, 64, 64, 3), np.float32)
    want = jax.device_get(jax_make_predict_fn(JaxFixed(), JaxConfig(**kw))(
        {"params": {"logits": jnp.asarray(logits)}}, jnp.asarray(images)))
    got = make_predict_fn(FixedLogits(logits), Config(device="cpu", **kw),
                          device="cpu")(images)
    assert got.boxes.shape == (2, 60, 4)
    for name in ("boxes", "classes", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-6)
    n_valid = int(got.valid.sum())
    assert 0 < n_valid < got.valid.numel()
    plain = make_predict_fn(FixedLogits(logits), Config(device="cpu", **dict(
        kw, nms="nms")), device="cpu")(images)
    same = torch.equal(got.scores, plain.scores)
    assert same == (mode != "soft-nms")
