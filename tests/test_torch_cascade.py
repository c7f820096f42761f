"""The cascade's pieces in the port on the CPU, mirroring
tests/test_cascade.py: the confidence signal (`ops.decode.
confidence_summary`, against JAX's on seeded scores), the calibrated
threshold (`config.cascade_overrides`, equal to JAX's on the committed
artifact and on written ones), and `make_predict_fn(cascade_summary=
True)` (the rows unchanged, the confidence one more leaf; against JAX's
predict: rows by `test_torch_predict`'s rule, the confidence within
1e-6 relative), and the engine's rows carrying it. Routing by the
confidence is in tests/test_torch_fleet.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu import config as jax_config
from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu.ops.decode import \
    confidence_summary as jax_confidence
from real_time_helmet_detection_tpu.predict import \
    make_predict_fn as jax_make_predict_fn
from real_time_helmet_detection_tpu.train import init_variables
from real_time_helmet_detection_tpu_torch import config as config_mod
from real_time_helmet_detection_tpu_torch import convert
from real_time_helmet_detection_tpu_torch.models.hourglass import \
    build_model
from real_time_helmet_detection_tpu_torch.obs.metrics import MetricsRegistry
from real_time_helmet_detection_tpu_torch.ops.decode import (
    MARGIN_K, CascadeDetections, Detections, confidence_summary)
from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
from real_time_helmet_detection_tpu_torch.serving import ServingEngine
from real_time_helmet_detection_tpu_torch.serving.runs import oracle_rows
from test_torch_predict import assert_detections_match, bn_scaled, rows


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


def conf(scores, valid):
    return confidence_summary(torch.as_tensor(scores),
                              torch.as_tensor(valid))


# ---------------------------------------------------------------------------
# confidence_summary


def test_confidence_summary_empty_image_is_least_confident():
    assert float(conf(np.zeros(32, np.float32), np.zeros(32, bool))) == 0.0


def test_confidence_summary_monotone_in_each_signal():
    topk = 32

    def c(score_list, n_valid):
        scores = np.zeros((topk,), np.float32)
        scores[:len(score_list)] = score_list
        valid = np.zeros((topk,), bool)
        valid[:n_valid] = True
        return float(conf(scores, valid))

    assert c([0.9], 1) > c([0.5], 1)
    assert c([0.9], 1) > c([0.9] * MARGIN_K, MARGIN_K)
    assert c([0.9, 0.8], 2) > c([0.9, 0.8] + [0.1] * 20, 22)


def test_confidence_summary_masks_invalid_scores():
    scores = np.zeros((32,), np.float32)
    scores[0], scores[1] = 0.7, 99.0
    valid = np.zeros((32,), bool)
    valid[0] = True
    a = float(conf(scores, valid))
    scores[1] = 0.0
    assert a == float(conf(scores, valid))


def test_confidence_summary_batched_matches_per_image():
    rng = np.random.default_rng(0)
    scores = rng.uniform(0.0, 1.0, size=(4, 32)).astype(np.float32)
    valid = rng.uniform(size=(4, 32)) < 0.4
    batched = conf(scores, valid).numpy()
    assert batched.shape == (4,) and batched.dtype == np.float32
    for i in range(4):
        assert batched[i] == float(conf(scores[i], valid[i]))


@pytest.mark.parametrize("seed,shape", [(0, (32,)), (1, (4, 16)),
                                        (2, (3, 200)), (3, (2, 5))])
def test_confidence_summary_matches_jax(seed, shape):
    """Seeded scores and masks (some all-invalid rows, fewer rows than
    MARGIN_K): the port's signal against JAX's, rtol 1e-6."""
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
    valid = rng.uniform(size=shape) < 0.5
    if len(shape) == 2:
        valid[0] = False
    want = np.asarray(jax_confidence(jnp.asarray(scores),
                                     jnp.asarray(valid)))
    got = conf(scores, valid).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_cascade_detections_view_drops_only_the_scalar():
    det = CascadeDetections(
        boxes=torch.zeros((8, 4)), classes=torch.zeros(8, dtype=torch.int32),
        scores=torch.zeros(8), valid=torch.zeros(8, dtype=torch.bool),
        confidence=torch.tensor(0.5))
    plain = det.detections()
    assert isinstance(plain, Detections)
    assert plain._fields == ("boxes", "classes", "scores", "valid")
    for name in plain._fields:
        assert getattr(plain, name) is getattr(det, name)


# ---------------------------------------------------------------------------
# cascade_overrides: the committed calibration is the operating point


def _write_calib(root, rnd, threshold):
    d = os.path.join(root, "artifacts", rnd)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "cascade.json"), "w") as f:
        json.dump({"schema": "cascade-calibration-v1",
                   "selected": {"threshold": threshold}}, f)


def test_cascade_overrides_highest_round_wins(tmp_path):
    root = str(tmp_path)
    _write_calib(root, "r09", 0.11)
    _write_calib(root, "r16", 0.29)
    over = config_mod.cascade_overrides(repo_root=root)
    assert over == jax_config.cascade_overrides(repo_root=root)
    assert over["cascade_threshold"] == 0.29 and "r16" in over["_source"]


def test_cascade_overrides_missing_artifact_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="--cascade-threshold"):
        config_mod.cascade_overrides(repo_root=str(tmp_path))


def test_cascade_overrides_tolerates_junk_artifacts(tmp_path):
    root = str(tmp_path)
    d = os.path.join(root, "artifacts", "r20")
    os.makedirs(d)
    with open(os.path.join(d, "cascade.json"), "w") as f:
        f.write("{torn")
    _write_calib(root, "r10", 0.2)
    over = config_mod.cascade_overrides(repo_root=root)
    assert over == jax_config.cascade_overrides(repo_root=root)
    assert over["cascade_threshold"] == 0.2


def test_apply_cascade_noop_when_off_or_explicit():
    cfg = config_mod.Config(cascade=False)
    assert config_mod.apply_cascade(cfg) is cfg
    cfg = config_mod.Config(cascade=True, cascade_threshold=0.5)
    assert config_mod.apply_cascade(cfg) is cfg


def test_committed_calibration_artifact_resolves():
    """The committed calibration resolves through `cascade_overrides` and
    through `get_config(["--cascade"])`: the port's own record from a
    full run on the card (the package's calibration/cascade.json) where
    there is one, JAX's newest artifact otherwise; JAX's loader reads its
    own artifacts whatever the port commits."""
    over = config_mod.cascade_overrides()
    own = os.path.join(os.path.dirname(config_mod.__file__), "calibration",
                       "cascade.json")
    if os.path.isfile(own):
        with open(own) as f:
            rec = json.load(f)
        assert (rec["platform"], rec["smoke"]) == ("gpu", False)
        assert over == {"cascade_threshold": rec["selected"]["threshold"],
                        "_source": os.path.join(
                            "real_time_helmet_detection_tpu_torch",
                            "calibration", "cascade.json")}
    else:
        assert over == jax_config.cascade_overrides()
    assert jax_config.cascade_overrides()["_source"].startswith("artifacts")
    assert isinstance(over["cascade_threshold"], float)
    cfg = config_mod.get_config(["--cascade", "--device", "cpu"])
    assert cfg.cascade_threshold == over["cascade_threshold"]
    assert config_mod.get_config(["--cascade", "--cascade-threshold",
                                  "0.5"]).cascade_threshold == 0.5


# ---------------------------------------------------------------------------
# the predict and the engine


ARCH = dict(imsize=64, variant="ghost", num_stack=1, hourglass_inch=16,
            stem_width=16)


@pytest.fixture(scope="module")
def ghost():
    jcfg = JaxConfig(**ARCH)
    jmodel = jax_build(jcfg)
    params, stats = init_variables(jmodel, jax.random.key(0), 64)
    variables = bn_scaled(jax.device_get({"params": params,
                                          "batch_stats": stats}), 4)
    cfg = config_mod.Config(device="cpu", **ARCH)
    model = convert.load_into(build_model(cfg), variables)
    images = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    return jcfg, jmodel, variables, cfg, model, images


def test_predict_cascade_summary_only_adds_a_leaf(ghost):
    """cascade_summary=True: CascadeDetections whose four leaves are the
    plain predict's bit for bit, plus a finite (B,) confidence equal to
    `confidence_summary` of those rows."""
    _, _, _, cfg, model, images = ghost
    plain = make_predict_fn(model, cfg, normalize="imagenet",
                            device="cpu")(images)
    casc = make_predict_fn(model, cfg, normalize="imagenet", device="cpu",
                           cascade_summary=True)(images)
    assert isinstance(casc, CascadeDetections)
    for name in Detections._fields:
        assert torch.equal(getattr(plain, name), getattr(casc, name))
    assert casc.confidence.shape == (2,)
    assert casc.confidence.dtype == torch.float32
    assert torch.isfinite(casc.confidence).all()
    assert torch.equal(casc.confidence,
                       confidence_summary(casc.scores, casc.valid))


def test_predict_cascade_summary_matches_jax(ghost):
    """Against JAX's cascade predict on the same weights: rows matched
    both ways, the confidence within 1e-6 relative."""
    jcfg, jmodel, variables, cfg, model, images = ghost
    want = jax.device_get(jax_make_predict_fn(
        jmodel, jcfg, normalize="imagenet", cascade_summary=True)(
        variables, jnp.asarray(images)))
    got = make_predict_fn(model, cfg, normalize="imagenet", device="cpu",
                          cascade_summary=True)(images)
    n = assert_detections_match(rows(got[:4]), rows(want[:4])) \
        + assert_detections_match(rows(want[:4]), rows(got[:4]))
    assert n > 0
    np.testing.assert_allclose(got.confidence.numpy(),
                               np.asarray(want.confidence), rtol=1e-6)


def test_engine_rows_carry_the_confidence(ghost):
    """Through the engine each row is a CascadeDetections whose five
    leaves equal the one-shot predict's at the bucket that served it;
    the plain predict's rows stay Detections."""
    _, _, _, cfg, model, images = ghost
    pool = list(images)
    for cascade, kind in ((True, CascadeDetections), (False, Detections)):
        predict = make_predict_fn(model, cfg, normalize="imagenet",
                                  device="cpu", cascade_summary=cascade)
        oracle = oracle_rows(predict, pool, (1, 2))
        with ServingEngine(predict, None, (64, 64, 3), np.uint8,
                           buckets=(1, 2), max_wait_ms=5.0,
                           metrics=MetricsRegistry()) as eng:
            futs = [eng.submit(img) for img in pool]
            for i, f in enumerate(futs):
                row = f.result(timeout=60)
                assert type(row) is kind
                assert all(np.array_equal(x, y) for x, y in
                           zip(row, oracle[(f.bucket, i)]))
        if cascade:
            assert row.confidence.shape == ()


def test_cascade_run_on_cpu(tmp_path):
    """`serving.runs --cascade` at a small size on the CPU, at the
    calibrated threshold: tier rows and the graph's confidence equal the
    oracles, answers follow the confidence, an escalation fault degrades
    to the edge answer, a quality replica's death still delivers."""
    from real_time_helmet_detection_tpu_torch.serving import runs
    out = runs.main(["--cascade", "--device", "cpu", "--imsize", "64",
                     "--pool", "2", "--duration", "0.3", "--clients", "4",
                     "--no-amp", "--out", str(tmp_path / "cascade.json")])
    out = out["engine"]  # the real-engine section of the record
    assert out["threshold"] == config_mod.cascade_overrides()[
        "cascade_threshold"]
    for tier, rec in out["pinned"].items():
        assert rec["equal"] == rec["rows"] > 0, tier
    assert out["pinned"]["edge"]["confidence_equal"] == 4
    c = out["cascade"]
    assert c["equal"] == c["follows_threshold"] == c["rows"] == 4
    assert out["lost"] == 0 and out["builds"] == [3, 5]
    f = out["faults"]
    assert f["lost_acks"] == f["lost"] == 0 and f["degraded"] == 1
    assert f["degraded_equal"] == 1
    assert f["quality_equal"] == f["requests"] - 1
    assert f["deaths"] == f["respawns"] == 1 and f["builds"] == [3, 5]
