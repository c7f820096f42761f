"""The port's input paths of the training runtime, on the CPU, against
its own thread loader and the JAX package's loaders:

* `ProcessBatchLoader` (`--loader process`): over 2 epochs every batch
  bit-identical to the port's `BatchLoader` and to JAX's
  `ProcessBatchLoader`, host and raw batches; no shared-memory segment
  left behind;
* its worker processes import no torch (their mapped libraries hold no
  libtorch) and initialise nothing of CUDA;
* the poison-batch quarantine (`--sentinel`): a batch with a NaN drops,
  counted; a killed worker: the loader falls back to the thread path
  with the same bytes, logged and counted (`fallbacks`,
  `train.loader_fallbacks`);
* `DevicePrefetcher` yields what `stage` gives, in order, `depth` ahead;
* `DeviceDatasetCache`: its canvases, boxes, labels and validity and its
  index order over 2 epochs equal JAX's;
* the raw collate (`--device-augment`'s host batch) equals JAX's.
"""

import glob
import os
import signal

import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu.data import augment as jax_augment
from real_time_helmet_detection_tpu.data import pipeline as jax_pipeline
from real_time_helmet_detection_tpu.data import shm_pool as jax_shm
from real_time_helmet_detection_tpu.data.voc import VOCDataset as JaxVOC
from real_time_helmet_detection_tpu_torch.data.augment import (
    TestAugmentor, TrainAugmentor)
from real_time_helmet_detection_tpu_torch.data.pipeline import (
    BatchLoader, DeviceDatasetCache, DevicePrefetcher, collate,
    seed_augmentor_for_batch)
from real_time_helmet_detection_tpu_torch.data.shm_pool import \
    ProcessBatchLoader
from real_time_helmet_detection_tpu_torch.data.synthetic import \
    make_synthetic_voc
from real_time_helmet_detection_tpu_torch.data.voc import VOCDataset
from real_time_helmet_detection_tpu_torch.obs.metrics import \
    default_registry

FIELDS = ("image", "heatmap", "offset", "wh", "mask", "boxes", "labels",
          "valid")
AUG = dict(multiscale_flag=True, multiscale=[32, 80, 16])


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    return make_synthetic_voc(str(tmp_path_factory.mktemp("voc")),
                              num_train=7, num_test=0, imsize=(96, 72),
                              seed=4)


def loader(cls, root, raw=False, **kw):
    aug = (TestAugmentor(64) if raw else
           TrainAugmentor(rng=np.random.default_rng(0), **AUG))
    return cls(VOCDataset(root), aug, batch_size=2, num_workers=2, seed=5,
               max_boxes=8, raw=raw, **kw)


def assert_same(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def epochs(ld, n=2):
    out = []
    for e in range(n):
        ld.set_epoch(e)
        out.append(list(ld))
    return out


@pytest.mark.parametrize("raw", [False, True], ids=["host", "raw"])
def test_process_loader_bit_identical(voc, raw):
    thread = epochs(loader(BatchLoader, voc, raw))
    proc = loader(ProcessBatchLoader, voc, raw)
    aug = (jax_augment.TestAugmentor(64) if raw else
           jax_augment.TrainAugmentor(rng=np.random.default_rng(0), **AUG))
    jproc = jax_shm.ProcessBatchLoader(JaxVOC(voc), aug, batch_size=2,
                                       num_workers=2, seed=5, max_boxes=8,
                                       raw=raw)
    try:
        got, want = epochs(proc), epochs(jproc)
    finally:
        proc.close()
        jproc.close()
    assert [len(e) for e in got] == [3, 3]
    for eg, et, ej in zip(got, thread, want):
        for g, t, j in zip(eg, et, ej):
            assert_same(g, t)
            assert_same(g, j)
    assert not glob.glob("/dev/shm/helmet_shm_%d_*" % os.getpid())


def test_workers_import_no_torch(voc):
    """The spawned workers' import chain is numpy only: no libtorch is
    mapped into them (read from /proc while they serve an epoch)."""
    proc = loader(ProcessBatchLoader, voc)
    try:
        it = iter(proc)
        next(it)
        pids = [p.pid for p in proc._procs]
        assert len(pids) == 2
        for pid in pids:
            with open("/proc/%d/maps" % pid) as f:
                maps = f.read()
            assert "libtorch" not in maps and "libc10" not in maps, pid
            assert "libcuda" not in maps, pid
        list(it)
    finally:
        proc.close()


class _PoisonAugmentor(TrainAugmentor):
    """NaN float canvases for one batch index (found from the per-batch
    reseed's entropy (seed, epoch, batch)), in the workers and in the
    thread fallback alike."""

    def __init__(self, poison_batch, **kw):
        super().__init__(**kw)
        self.poison_batch = int(poison_batch)

    def __call__(self, images, boxes, labels):
        images, boxes, labels = super().__call__(images, boxes, labels)
        ent = self.rng.bit_generator.seed_seq.entropy
        if tuple(ent)[2] == self.poison_batch:
            images = [np.full(im.shape, np.nan, np.float32) for im in images]
        return images, boxes, labels


def test_quarantine_drops_and_counts(voc):
    aug = _PoisonAugmentor(1, rng=np.random.default_rng(0), **AUG)
    proc = ProcessBatchLoader(VOCDataset(voc), aug, batch_size=2,
                              num_workers=2, seed=5, max_boxes=8,
                              quarantine=True)
    clean = list(loader(BatchLoader, voc))
    try:
        got = list(proc)
        assert "quarantined:1" in proc.worker_status()
    finally:
        proc.close()
    assert proc.quarantined == 1 and len(got) == len(clean) - 1
    for g, t in zip(got, clean[:1] + clean[2:]):
        assert_same(g, t)


def test_killed_worker_falls_back_counted(voc, capsys):
    want = epochs(loader(BatchLoader, voc))
    proc = loader(ProcessBatchLoader, voc)
    counter = default_registry().counter("train.loader_fallbacks")
    before = counter.value
    try:
        proc.set_epoch(0)
        got0 = list(proc)
        for pid in [p.pid for p in proc._procs]:
            os.kill(pid, signal.SIGKILL)
        proc.set_epoch(1)
        got1 = list(proc)
    finally:
        proc.close()
    assert proc.fallbacks == 1 and counter.value == before + 1
    assert "falling back to the thread loader" in capsys.readouterr().out
    for g, w in zip(got0 + got1, want[0] + want[1]):
        assert_same(g, w)
    assert "FELL-BACK-TO-THREAD" in proc.worker_status()
    assert not glob.glob("/dev/shm/helmet_shm_%d_*" % os.getpid())


def test_device_prefetcher_order_and_depth():
    staged = []

    def stage(item):
        staged.append(item)
        return (torch.full((2,), float(item)),)

    seen = []
    for sb in DevicePrefetcher(range(6), stage, depth=2):
        # `depth` items are staged ahead of the one handed over
        assert len(staged) == min(6, sb.host + 3)
        seen.append((sb.host, float(sb.arrays[0][0])))
    assert seen == [(i, float(i)) for i in range(6)]


def test_device_dataset_cache_matches_jax(voc):
    cache = DeviceDatasetCache(VOCDataset(voc), TestAugmentor(64),
                               batch_size=3, max_boxes=8, seed=5,
                               num_workers=2, device="cpu")
    jcache = jax_pipeline.DeviceDatasetCache(
        JaxVOC(voc), jax_augment.TestAugmentor(64), batch_size=3,
        max_boxes=8, seed=5, num_workers=2)
    for name in ("images", "boxes", "labels", "valid"):
        np.testing.assert_array_equal(getattr(cache, name).numpy(),
                                      np.asarray(getattr(jcache, name)),
                                      err_msg=name)
    assert cache.nbytes == 7 * (64 * 64 * 3 + 8 * 4 * 4 + 8 * 4 + 8)
    for epoch in (0, 1):
        cache.set_epoch(epoch)
        jcache.set_epoch(epoch)
        got, want = list(cache), list(jcache)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    assert cache.alive()


def test_raw_collate_matches_jax(voc):
    idx = [3, 0, 6]
    pset, jset = VOCDataset(voc), JaxVOC(voc)
    paug = TrainAugmentor(rng=np.random.default_rng(1), **AUG)
    jaug = jax_augment.TrainAugmentor(rng=np.random.default_rng(1), **AUG)
    seed_augmentor_for_batch(paug, 5, 2, 1)
    jax_pipeline.seed_augmentor_for_batch(jaug, 5, 2, 1)
    got = collate([pset[i] for i in idx], paug, max_boxes=8, raw=True)
    want = jax_pipeline.collate([jset[i] for i in idx], jaug, max_boxes=8,
                                raw=True)
    assert got.image.dtype == np.uint8 and got.heatmap.shape[1:] == (0, 0, 0)
    assert_same(got, want)
