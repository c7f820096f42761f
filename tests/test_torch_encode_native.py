"""The port's native host GT encoder (data/encode_native.py over its copy
of the C++ source, cpp/encode.cc) against the JAX package's native
encoder and the numpy encoders of both packages, on the CPU.

* Against JAX's native encoder (the same arithmetic, the same g++
  flags): every map bit-exact, one image and a batch.
* Against the numpy encoders (the port's `ops/encode.py`, which is
  JAX's): offset, size and mask bit-exact; heat within rtol 1e-6, atol
  1e-7, the bound JAX's own test holds its native encoder to
  (tests/test_encode_native.py): float32 `exp` differs by an ulp between
  numpy's vectorized loop and the C library (observed 3.0e-8).
* The collate of the train loaders (`native=True`) gives JAX's collate
  bit for bit.
* The library is keyed by a hash of its source and flags under
  build/torch_kernels, and a failed build raises: there is no numpy
  fallback.

JAX's native encoder is reached through a private build of its source
(`jax_private_native`, module-scoped): JAX's own library path is shared
by every pytest worker, which rebuilds it in place when it finds it
missing or stale, and a worker that loads it half-written falls back to
numpy for the rest of its life (`encode_boxes_native` returning None).
"""

import os
import subprocess

import numpy as np
import pytest

from real_time_helmet_detection_tpu.data.pipeline import \
    collate as jax_collate
from real_time_helmet_detection_tpu.data.pipeline import \
    load_dataset as jax_load_dataset
from real_time_helmet_detection_tpu.data.pipeline import \
    seed_augmentor_for_batch as jax_seed
from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.ops import encode_native as jax_native
from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.data import encode_native
from real_time_helmet_detection_tpu_torch.data.pipeline import (
    collate, load_dataset, seed_augmentor_for_batch)
from real_time_helmet_detection_tpu_torch.data.synthetic import \
    make_synthetic_voc
from real_time_helmet_detection_tpu_torch.ops.encode import (
    encode_boxes, encode_boxes_batch)

NAMES = ("heat", "offset", "size", "mask")


@pytest.fixture(scope="module", autouse=True)
def jax_private_native(tmp_path_factory):
    """JAX's `cpp/hostops/encode.cc` compiled with JAX's flags (its
    `_build`) into a directory of this module's own, and JAX's loader
    pointed at it for the module's duration, its cached state reset
    before and restored after."""
    lib = str(tmp_path_factory.mktemp("jax_hostops") / "libhostops.so")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                    jax_native._SRC, "-o", lib], check=True,
                   capture_output=True)
    assert os.path.exists(lib)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB", lib)
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_load_failed", False)
        assert jax_native.native_available(), "JAX's native encoder " \
            "did not load from its private build %s" % lib
        yield lib


def boxes_of(seed, n, size=128):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-8, size, (n, 2))
    wh = rng.uniform(1, 60, (n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.integers(0, 2, n).astype(np.int32)
    if n > 3:  # two boxes on one centre cell: the last one wins
        boxes[3] = boxes[2] + np.float32(0.25)
    return boxes, labels


def assert_numpy_rule(got, want):
    for name, g, w in zip(NAMES, got, want):
        if name == "heat":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("n", [0, 1, 7, 40])
def test_single_image(n, normalized):
    boxes, labels = boxes_of(n, n)
    got = encode_native.encode_boxes_native(boxes, labels, (128, 96),
                                            normalized=normalized)
    jax_got = jax_native.encode_boxes_native(boxes, labels, (128, 96),
                                             normalized=normalized)
    for name, g, w in zip(NAMES, got, jax_got):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert_numpy_rule(got, encode_boxes(boxes, labels, (128, 96),
                                        normalized=normalized))


def test_batch():
    per = [boxes_of(s, n) for s, n in enumerate((5, 0, 17, 3))]
    pb = np.zeros((4, 20, 4), np.float32)
    pl = np.zeros((4, 20), np.int32)
    counts = np.array([len(b) for b, _ in per], np.int32)
    for i, (b, lb) in enumerate(per):
        pb[i, :len(b)], pl[i, :len(b)] = b, lb
    got = encode_native.encode_boxes_batch_native(pb, pl, counts,
                                                  (128, 128))
    jax_got = jax_native.encode_boxes_batch_native(pb, pl, counts,
                                                   (128, 128))
    for name, g, w in zip(NAMES, got, jax_got):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert_numpy_rule(got, encode_boxes_batch([b for b, _ in per],
                                              [lb for _, lb in per],
                                              (128, 128)))


def test_loader_collate_is_jax_collate(tmp_path):
    root = make_synthetic_voc(str(tmp_path / "voc"), num_train=4,
                              num_test=0, imsize=(120, 90), seed=2)
    kw = dict(data=root, train_flag=True, multiscale=[64, 128, 32],
              multiscale_flag=True, random_seed=3)
    jset, jaug = jax_load_dataset(JaxConfig(**kw))
    pset, paug = load_dataset(Config(device="cpu", **kw))
    jax_seed(jaug, 3, 1, 0)
    seed_augmentor_for_batch(paug, 3, 1, 0)
    want = jax_collate([jset[i] for i in range(4)], jaug)
    got = collate([pset[i] for i in range(4)], paug, native=True)
    for name in ("image", "heatmap", "offset", "wh", "mask", "boxes",
                 "labels", "valid"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


def test_library_is_keyed_and_a_failed_build_raises(tmp_path, monkeypatch):
    path = encode_native.library_path()
    encode_native.load()
    assert path.startswith(encode_native.BUILD_DIR)
    assert "hostops_encode-" in path and path.endswith(".so")
    monkeypatch.setattr(encode_native, "_lib", None)
    monkeypatch.setattr(encode_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(encode_native, "CXX_COMMAND",
                        ("g++", "-std=c++99999", "-shared", "-fPIC"))
    with pytest.raises(RuntimeError, match="native encoder failed"):
        encode_native.load()
    assert list(tmp_path.iterdir()) == []  # no temporary file left
