"""The streaming plane of the port on the CPU, mirroring
tests/test_streams.py: the tile delta summary (`ops.delta`, against
JAX's on seeded uint8 pairs, rtol 1e-6), the StreamSession's gating,
reassembly, in-order delivery and degradation over a deterministic fake
server, `smooth_tile` and `stitch_detections` (identical to JAX's), the
calibrated threshold (`config.stream_overrides`, equal to JAX's), then a
session of each package over its own engine on the same seeded frames,
and the streams run (`serving.runs --streams`) at a small size.
"""

import argparse
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu import config as jax_config
from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu.ops.decode import \
    Detections as JaxDetections
from real_time_helmet_detection_tpu.ops.delta import \
    stitch_detections as jax_stitch
from real_time_helmet_detection_tpu.ops.delta import \
    tile_delta_summary as jax_delta
from real_time_helmet_detection_tpu.predict import \
    make_predict_fn as jax_make_predict_fn
from real_time_helmet_detection_tpu.serving import \
    ServingEngine as JaxServingEngine
from real_time_helmet_detection_tpu.serving.streams import \
    StreamSession as JaxStreamSession
from real_time_helmet_detection_tpu.serving.streams import \
    smooth_tile as jax_smooth_tile
from real_time_helmet_detection_tpu.train import init_variables
from real_time_helmet_detection_tpu_torch import config as config_mod
from real_time_helmet_detection_tpu_torch import convert
from real_time_helmet_detection_tpu_torch.models.hourglass import \
    build_model
from real_time_helmet_detection_tpu_torch.obs.metrics import MetricsRegistry
from real_time_helmet_detection_tpu_torch.ops.decode import Detections
from real_time_helmet_detection_tpu_torch.ops.delta import (
    DeltaFn, make_delta_fn, stitch_detections, tile_delta_summary,
    tile_origins, tile_shape)
from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
from real_time_helmet_detection_tpu_torch.runtime import (ChaosInjector,
                                                          FaultSchedule)
from real_time_helmet_detection_tpu_torch.serving import (ServingEngine,
                                                          StreamSession,
                                                          smooth_tile)
from real_time_helmet_detection_tpu_torch.serving import runs
from test_torch_predict import assert_detections_match, bn_scaled


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file's engines run: their threads
    and the oracle's would otherwise each bring a full pool, and under the
    suite's parallel workers the oversubscribed pools stall (the rows do
    not depend on it: oracle and engine run under the same setting)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def delta(a, b, grid=2):
    return tile_delta_summary(torch.as_tensor(a), torch.as_tensor(b),
                              grid).numpy()


def session(server, shape=(64, 64, 3), **kw):
    return StreamSession(server, shape, device="cpu", **kw)


# ---------------------------------------------------------------------------
# tile_delta_summary


def test_delta_identical_frames_is_zero():
    f = np.random.default_rng(0).integers(0, 256, (64, 64, 3), np.uint8)
    d = delta(f, f)
    assert d.shape == (4,) and d.dtype == np.float32 and np.all(d == 0.0)


def test_delta_no_uint8_wraparound():
    a = np.full((32, 32, 3), 250, np.uint8)
    b = np.full((32, 32, 3), 5, np.uint8)
    assert np.all(delta(a, b) == 245.0)


def test_delta_localizes_to_the_changed_tile():
    rng = np.random.default_rng(1)
    prev = rng.integers(0, 256, (64, 64, 3), np.uint8)
    cur = prev.copy()
    th, tw = tile_shape((64, 64, 3), 2)
    (y0, x0) = tile_origins((64, 64, 3), 2)[3]
    cur[y0:y0 + th, x0:x0 + tw] = rng.integers(0, 256, (th, tw, 3),
                                               np.uint8)
    d = delta(prev, cur)
    assert np.all(d[:3] == 0.0) and d[3] > 10.0


def test_delta_fn_matches_direct_call():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, (64, 64, 3), np.uint8)
    b = rng.integers(0, 256, (64, 64, 3), np.uint8)
    fn = make_delta_fn(2, device="cpu")
    assert isinstance(fn, DeltaFn) and fn.device.type == "cpu"
    assert np.array_equal(fn(a, b), delta(a, b))
    assert np.array_equal(fn(fn.upload(a), fn.upload(b)), delta(a, b))


@pytest.mark.parametrize("seed,hw,grid", [(0, 64, 2), (1, 96, 3),
                                          (2, 128, 4), (3, 64, 1)])
def test_delta_summary_matches_jax(seed, hw, grid):
    """Seeded uint8 pairs, partly equal: the port's summary against
    JAX's, rtol 1e-6."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (hw, hw, 3), np.uint8)
    b = np.where(rng.uniform(size=(hw, hw, 1)) < 0.5, a,
                 rng.integers(0, 256, (hw, hw, 3), np.uint8))
    want = np.asarray(jax_delta(jnp.asarray(a), jnp.asarray(b), grid))
    got = delta(a, b, grid)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_delta_integer_sums_at_frame_size():
    """A 1024^2 x 3 pair, whose tile sums pass 2^24: each value is the
    exact mean rounded once to float32 (the integer sum, then one
    division), what the card computes as well."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (1024, 1024, 3), np.uint8)
    b = rng.integers(0, 256, (1024, 1024, 3), np.uint8)
    got = delta(a, b)
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
    sums = diff.reshape(2, 512, 2, 512, 3).sum(axis=(1, 3, 4)).reshape(-1)
    assert sums.max() > 2 ** 24
    want = sums.astype(np.float32) / np.float32(512 * 512 * 3)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# a deterministic fake server (the answer is a function of the bytes)


def _det_for(img: np.ndarray) -> Detections:
    img = np.asarray(img)
    base = img[:4, 0, 0].astype(np.float32)
    return Detections(
        boxes=np.stack([base, base, base + 4.0, base + 4.0], axis=-1),
        classes=(img[:4, 1, 0].astype(np.int32) % 2),
        scores=img[:4, 2, 0].astype(np.float32) / 255.0,
        valid=np.ones((4,), bool))


class _FakeFut:
    def __init__(self, value=None, error=None, hold=False):
        self._value, self._error = value, error
        self._event = threading.Event()
        if not hold:
            self._event.set()

    def release(self):
        self._event.set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("fake future held")
        if self._error is not None:
            raise self._error
        return self._value


class _FakeServer:
    def __init__(self, hold=False, fail_at=()):
        self.hold = hold
        self.fail_at = set(fail_at)
        self.submitted = []
        self.futs = []

    def submit(self, image, block=False, deadline_s=None, **kw):
        i = len(self.submitted)
        self.submitted.append(np.asarray(image).copy())
        if i in self.fail_at:
            f = _FakeFut(error=RuntimeError("injected request failure"),
                         hold=self.hold)
        else:
            f = _FakeFut(value=_det_for(image), hold=self.hold)
        self.futs.append(f)
        return f


def _frame(rng, hw=64):
    return rng.integers(0, 256, (hw, hw, 3), np.uint8)


def _same(a, b) -> bool:
    return all(np.array_equal(getattr(a, n), getattr(b, n))
               for n in Detections._fields)


# ---------------------------------------------------------------------------
# StreamSession contracts


def test_gated_session_requires_threshold():
    with pytest.raises(ValueError):
        session(_FakeServer(), grid=2)


def test_gate_off_passes_the_whole_frame_through():
    srv = _FakeServer()
    sess = session(srv, gate=False)
    rng = np.random.default_rng(3)
    try:
        for i in range(3):
            f = _frame(rng)
            res = sess.submit_frame(f).result(timeout=30)
            assert len(srv.submitted) == i + 1
            assert np.array_equal(srv.submitted[i], f)
            assert _same(res.detections, _det_for(f))
            assert res.computed_tiles == res.total_tiles and not res.gap
    finally:
        sess.close()


def test_first_frame_computes_all_then_static_skips():
    srv = _FakeServer()
    sess = session(srv, grid=2, threshold=1.0, ema=0.0)
    f0 = _frame(np.random.default_rng(4))
    try:
        r0 = sess.submit_frame(f0).result(timeout=30)
        assert r0.computed_tiles == 4 and len(srv.submitted) == 4
        r1 = sess.submit_frame(f0.copy()).result(timeout=30)
        assert r1.computed_tiles == 0 and len(srv.submitted) == 4
        assert _same(r1.detections, r0.detections)
        st = sess.stats()
        assert st["computed_tiles"] == 4 and st["skipped_tiles"] == 4
        assert st["tile_skip_rate"] == 0.5
    finally:
        sess.close()


def test_session_uploads_each_frame_once(monkeypatch):
    """The previous frame stays on the summary's device: each gated
    frame is uploaded once, and the summary sees uploaded tensors."""
    uploads = []
    orig = DeltaFn.upload

    def counting(self, frame):
        uploads.append(1)
        return orig(self, frame)

    monkeypatch.setattr(DeltaFn, "upload", counting)
    srv = _FakeServer()
    sess = session(srv, grid=2, threshold=1.0, ema=0.0)
    rng = np.random.default_rng(11)
    try:
        for _ in range(3):
            sess.submit_frame(_frame(rng)).result(timeout=30)
        assert len(uploads) == 3
        assert torch.is_tensor(sess._prev)
    finally:
        sess.close()


def test_all_changed_frame_reassembles_to_the_tile_oracle():
    srv = _FakeServer()
    sess = session(srv, grid=2, threshold=1.0, ema=0.0)
    rng = np.random.default_rng(5)
    th, tw = tile_shape((64, 64, 3), 2)
    origins = tile_origins((64, 64, 3), 2)
    try:
        sess.submit_frame(_frame(rng)).result(timeout=30)
        f1 = _frame(rng)
        r1 = sess.submit_frame(f1).result(timeout=30)
        assert r1.computed_tiles == 4
        want = stitch_detections(
            [_det_for(f1[y0:y0 + th, x0:x0 + tw]) for (y0, x0) in origins],
            origins)
        assert _same(r1.detections, want)
    finally:
        sess.close()


def test_in_order_delivery_under_out_of_order_completion():
    srv = _FakeServer(hold=True)
    sess = session(srv, grid=2, threshold=1.0, ema=0.0)
    rng = np.random.default_rng(6)
    delivered = []
    try:
        futs = [sess.submit_frame(_frame(rng)) for _ in range(3)]
        for f in futs:
            f.add_done_callback(
                lambda fr: delivered.append(fr.result(timeout=0).seq))
        for fut in reversed(srv.futs):
            fut.release()
        for f in futs:
            f.result(timeout=30)
        assert delivered == [0, 1, 2]
    finally:
        sess.close()


def test_failed_tile_degrades_to_cache_never_lost():
    srv = _FakeServer(fail_at=(5,))
    sess = session(srv, grid=2, threshold=1.0, ema=0.0)
    rng = np.random.default_rng(7)
    try:
        r0 = sess.submit_frame(_frame(rng)).result(timeout=30)
        r1 = sess.submit_frame(_frame(rng)).result(timeout=30)
        assert r0.degraded_tiles == 0 and r1.degraded_tiles == 1
        # the failed tile (index 1 of the second frame) is frame 0's
        n = len(r0.detections.boxes) // 4
        assert np.array_equal(r1.detections.boxes[n:2 * n],
                              r0.detections.boxes[n:2 * n])
        st = sess.stats()
        assert st["degraded_tiles"] == 1 and st["delivered"] == 2
    finally:
        sess.close()


def test_frame_faults_answer_from_the_cache():
    """stream:frame faults: a dropped and a corrupt frame answer from the
    cache and never become the delta reference; a late frame is counted;
    every frame delivers, in order."""
    inj = ChaosInjector(FaultSchedule.parse(
        "stream:frame=dropped-frame@2,stream:frame=corrupt-frame@3,"
        "stream:frame=late-frame@4"))
    srv = _FakeServer()
    sess = session(srv, grid=2, threshold=1.0, ema=0.0, injector=inj)
    rng = np.random.default_rng(8)
    f0 = _frame(rng)
    try:
        r = [sess.submit_frame(f).result(timeout=30)
             for f in (f0, _frame(rng), _frame(rng), f0.copy())]
        assert [x.seq for x in r] == [0, 1, 2, 3]
        assert r[1].gap and r[2].gap and r[1].computed_tiles == 0
        assert _same(r[1].detections, r[0].detections)
        # the reference is still frame 0: its copy computes nothing
        assert r[3].late and r[3].computed_tiles == 0
        st = sess.stats()
        assert (st["gaps"], st["corrupt"], st["late"]) == (2, 1, 1)
        assert len(srv.submitted) == 4
    finally:
        sess.close()


def test_future_timestamps_order():
    sess = session(_FakeServer(), gate=False)
    try:
        fut = sess.submit_frame(_frame(np.random.default_rng(8)))
        fut.result(timeout=30)
        assert fut.t_done is not None and fut.t_done >= fut.t_submit
    finally:
        sess.close()


def test_session_fps_comes_from_delivery_clock():
    sess = session(_FakeServer(), gate=False)
    rng = np.random.default_rng(10)
    try:
        for _ in range(4):
            sess.submit_frame(_frame(rng))
        sess.drain(timeout=30)
        time.sleep(0.01)
        st = sess.stats()
        assert st["delivered"] == 4 and st["fps"] > 0
    finally:
        sess.close()


# ---------------------------------------------------------------------------
# smooth_tile and stitching, identical to JAX's


def _tile_det(boxes, classes, scores, valid=None):
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    n = len(boxes)
    return Detections(
        boxes=boxes, classes=np.asarray(classes, np.int32),
        scores=np.asarray(scores, np.float32),
        valid=(np.ones((n,), bool) if valid is None
               else np.asarray(valid, bool)))


def test_smooth_tile_ema_zero_returns_new_untouched():
    new = _tile_det([[0, 0, 8, 8]], [1], [0.9])
    prev = _tile_det([[0, 0, 8, 8]], [1], [0.1])
    assert np.array_equal(smooth_tile(new, prev, 0.0, 8.0).scores,
                          new.scores)


def test_smooth_tile_blends_matched_scores_keeps_new_geometry():
    prev = _tile_det([[0, 0, 8, 8]], [1], [0.2])
    new = _tile_det([[1, 1, 9, 9]], [1], [0.8])
    out = smooth_tile(new, prev, ema=0.5, radius=8.0)
    assert out.scores[0] == pytest.approx(0.5 * 0.2 + 0.5 * 0.8)
    assert np.array_equal(out.boxes, new.boxes)


def test_smooth_tile_respects_class_and_radius():
    prev = _tile_det([[0, 0, 8, 8], [40, 40, 48, 48]], [1, 1], [0.2, 0.3])
    new = _tile_det([[0, 0, 8, 8], [40, 40, 48, 48]], [0, 1], [0.8, 0.7])
    out = smooth_tile(new, prev, ema=0.5, radius=8.0)
    assert out.scores[0] == pytest.approx(0.8)
    assert out.scores[1] == pytest.approx(0.5 * 0.3 + 0.5 * 0.7)
    out2 = smooth_tile(new, prev, ema=0.5, radius=0.1)
    assert out2.scores[1] == pytest.approx(0.5 * 0.3 + 0.5 * 0.7)


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_smooth_tile_identical_to_jax(seed):
    """Seeded tiles (some rows invalid, both classes): the port's
    smoothing equals JAX's bit for bit, and is deterministic."""
    rng = np.random.default_rng(seed)

    def draw():
        return (rng.uniform(0, 32, (6, 4)), rng.integers(0, 2, 6),
                rng.uniform(size=6), rng.uniform(size=6) < 0.7)
    prev, new = _tile_det(*draw()), _tile_det(*draw())
    a = smooth_tile(new, prev, ema=0.5, radius=8.0)
    b = smooth_tile(new, prev, ema=0.5, radius=8.0)
    want = jax_smooth_tile(JaxDetections(*new), JaxDetections(*prev), 0.5,
                           8.0)
    for name in Detections._fields:
        assert np.array_equal(getattr(a, name), getattr(b, name))
        got, ref = getattr(a, name), np.asarray(getattr(want, name))
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_stitch_detections_identical_to_jax():
    rng = np.random.default_rng(12)
    origins = tile_origins((96, 96, 3), 3)
    dets = [_tile_det(rng.uniform(0, 32, (5, 4)), rng.integers(0, 2, 5),
                      rng.uniform(size=5), rng.uniform(size=5) < 0.5)
            for _ in origins]
    got = stitch_detections(dets, origins)
    want = jax_stitch([JaxDetections(*d) for d in dets], origins)
    for name in Detections._fields:
        ref = np.asarray(getattr(want, name))
        assert getattr(got, name).dtype == ref.dtype
        assert np.array_equal(getattr(got, name), ref)
    with pytest.raises(ValueError):
        stitch_detections(dets[:-1], origins)


# ---------------------------------------------------------------------------
# stream_overrides


def _write_calib(root, rnd, threshold):
    d = os.path.join(root, "artifacts", rnd)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "streams.json"), "w") as f:
        json.dump({"schema": "stream-calibration-v1",
                   "selected": {"threshold": threshold}}, f)


def test_stream_overrides_highest_round_wins(tmp_path):
    root = str(tmp_path)
    _write_calib(root, "r09", 11.0)
    _write_calib(root, "r17", 25.5)
    over = config_mod.stream_overrides(repo_root=root)
    assert over == jax_config.stream_overrides(repo_root=root)
    assert over["stream_threshold"] == 25.5 and "r17" in over["_source"]


def test_stream_overrides_missing_artifact_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="--stream-threshold"):
        config_mod.stream_overrides(repo_root=str(tmp_path))


def test_stream_overrides_tolerates_junk_artifacts(tmp_path):
    root = str(tmp_path)
    d = os.path.join(root, "artifacts", "r20")
    os.makedirs(d)
    with open(os.path.join(d, "streams.json"), "w") as f:
        f.write("{torn")
    _write_calib(root, "r10", 7.25)
    over = config_mod.stream_overrides(repo_root=root)
    assert over == jax_config.stream_overrides(repo_root=root)
    assert over["stream_threshold"] == 7.25


def test_apply_streams_noop_when_off_or_explicit():
    cfg = config_mod.Config(stream=False)
    assert config_mod.apply_streams(cfg) is cfg
    cfg = config_mod.Config(stream=True, stream_threshold=12.0)
    assert config_mod.apply_streams(cfg) is cfg


def test_committed_calibration_artifact_resolves():
    """As the cascade's (tests/test_torch_cascade.py): the port's own card
    record where there is one, else JAX's newest artifact."""
    over = config_mod.stream_overrides()
    own = os.path.join(os.path.dirname(config_mod.__file__), "calibration",
                       "streams.json")
    if os.path.isfile(own):
        with open(own) as f:
            rec = json.load(f)
        assert (rec["platform"], rec["smoke"]) == ("gpu", False)
        assert over == {"stream_threshold": rec["selected"]["threshold"],
                        "_source": os.path.join(
                            "real_time_helmet_detection_tpu_torch",
                            "calibration", "streams.json")}
    else:
        assert over == jax_config.stream_overrides()
    assert jax_config.stream_overrides()["_source"].startswith("artifacts")
    cfg = config_mod.get_config(["--stream", "--device", "cpu"])
    assert cfg.stream_threshold == over["stream_threshold"]


# ---------------------------------------------------------------------------
# a session of each package over its own engine


ARCH = dict(num_stack=1, hourglass_inch=16, num_cls=2, topk=16,
            conf_th=0.0, nms_th=0.5, imsize=64)


class _Recorder:
    """Passes submits on and keeps each submitted tile."""

    def __init__(self, server):
        self.server, self.tiles = server, []

    def submit(self, image, **kw):
        self.tiles.append(np.asarray(image).copy())
        return self.server.submit(image, **kw)


def _computed_sets(tiles, frames, results, origins, hw):
    """For each delivered frame, the tile indices it computed (matched
    by the submitted bytes, in submit order)."""
    out, k = [], 0
    for frame, res in zip(frames, results):
        got = set()
        for _ in range(res.computed_tiles):
            tile = tiles[k]
            k += 1
            got |= {t for t, (y0, x0) in enumerate(origins)
                    if np.array_equal(frame[y0:y0 + hw, x0:x0 + hw], tile)}
        out.append(sorted(got))
    return out


def test_stream_session_matches_jax_session():
    """The same seeded 128^2 frames (2 x 2 tiles of 64^2, redundancy
    0.5) through a session of each package over its own engine, at the
    calibrated threshold: the same tiles computed in every frame, frames
    delivered in order, detections matched both ways."""
    jcfg = JaxConfig(**ARCH)
    jmodel = jax_build(jcfg)
    params, stats = init_variables(jmodel, jax.random.key(0), 64)
    variables = bn_scaled(jax.device_get({"params": params,
                                          "batch_stats": stats}), 1)
    cfg = config_mod.Config(device="cpu", **ARCH)
    predict = make_predict_fn(convert.load_into(build_model(cfg),
                                                variables), cfg,
                              normalize="imagenet", device="cpu")
    args = argparse.Namespace(seed=0, tile_grid=2, imsize=64,
                              redundancy=0.5)
    frames = runs.synth_stream_frames(args, 0, 8)
    origins = tile_origins(frames[0].shape, 2)
    # one threshold for both sessions: JAX's committed one
    th = jax_config.stream_overrides()["stream_threshold"]
    got = {}
    for name in ("port", "jax"):
        if name == "port":
            eng = ServingEngine(predict, None, (64, 64, 3), np.uint8,
                                buckets=(1, 2, 4), max_wait_ms=2.0,
                                metrics=MetricsRegistry())
            rec = _Recorder(eng)
            sess = StreamSession(rec, frames[0].shape, grid=2, threshold=th,
                                 device="cpu")
        else:
            eng = JaxServingEngine(
                jax_make_predict_fn(jmodel, jcfg, normalize="imagenet"),
                variables, (64, 64, 3), np.uint8, buckets=(1, 2, 4),
                max_wait_ms=2.0)
            rec = _Recorder(eng)
            sess = JaxStreamSession(rec, frames[0].shape, grid=2,
                                    threshold=th)
        # a frame at a time: the tile cache fills at delivery, and a
        # tile without a cache computes regardless
        order, results = [], []
        for f in frames:
            fut = sess.submit_frame(f)
            fut.add_done_callback(
                lambda fr: order.append(fr.result(timeout=0).seq))
            results.append(fut.result(timeout=120))
        sess.close()
        eng.close()
        got[name] = dict(order=order, results=results,
                         sets=_computed_sets(rec.tiles, frames, results,
                                             origins, 64))
    p, j = got["port"], got["jax"]
    assert p["order"] == j["order"] == list(range(len(frames)))
    assert p["sets"] == j["sets"]
    assert p["sets"][0] == [0, 1, 2, 3]
    assert any(len(s) < 4 for s in p["sets"][1:])
    for rp, rj in zip(p["results"], j["results"]):
        assert rp.computed_tiles == rj.computed_tiles

    def valid(rs):
        return [(np.asarray(r.detections.boxes)[np.asarray(
            r.detections.valid)], np.asarray(r.detections.classes)[
            np.asarray(r.detections.valid)], np.asarray(
            r.detections.scores)[np.asarray(r.detections.valid)])
            for r in rs]
    n = assert_detections_match(valid(p["results"]), valid(j["results"])) \
        + assert_detections_match(valid(j["results"]), valid(p["results"]))
    assert n > 0


def test_streams_run_on_cpu(tmp_path):
    """`serving.runs --streams` at a small size on the CPU: the summary
    equals itself across devices (both the CPU here), gating and the
    tile oracle hold, frames deliver in order, faults deliver from the
    cache."""
    out = runs.main(["--streams", "--device", "cpu", "--imsize", "64",
                     "--streams-n", "2", "--stream-frames", "4",
                     "--duration", "0.3", "--no-amp",
                     "--out", str(tmp_path / "streams.json")])
    out = out["engine"]  # the real-engine section of the record
    assert out["threshold"] == config_mod.stream_overrides()[
        "stream_threshold"]
    assert out["delta"]["equal"] == out["delta"]["pairs"] == 6
    g = out["gating"]
    assert (g["first_computed"], g["copy_computed"], g["changed_computed"]) \
        == (4, 0, 4)
    assert g["copy_same"] and g["first_oracle"] == g["changed_oracle"] == 4
    assert out["in_order"] and out["builds"] == [3]
    assert all(a["lost"] == 0 for a in out["arms"].values())
    f = out["faults"]
    assert f["lost"] == 0 and f["in_order"] and f["delivered"] == 10
    assert (f["gaps"], f["corrupt"], f["late"]) == (2, 1, 1)
    assert f["degraded_tiles"] > 0
