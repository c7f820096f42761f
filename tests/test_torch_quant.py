"""The port's int8 inference path against the JAX package's, on the CPU.

Same numpy inputs through `real_time_helmet_detection_tpu.ops.quant` /
its int8 model twin and through the port (`ops/quant.py`,
`ops/qconv.py`'s plain versions, `models/hourglass.py`'s twin):

* the BN fold: each side folds the same checkpoint. XLA-CPU's rsqrt is
  not correctly rounded (one ulp off, while the port's is), and two
  float32 roundings follow it, so a folded kernel lands within 3 ulps of
  JAX's and a folded bias within 4 ulps of the larger of its two terms
  ((conv bias - mean) * inv and beta);
* the quantizers: `quantize_weights` and `quantize_activations` equal on
  the same float32 input (ties at .5, +-inf, saturation, NaN);
* `QuantConv` (dense 3x3, dense 1x1, depthwise 3x3) on the same folded
  weights, clip range and input: the int32 sums equal; the float32
  output within rtol 1e-6 (XLA may contract the rescale to an FMA), the
  bfloat16 output within one bf16 ulp (XLA may keep the product in
  float32 before the add);
* calibration (abs-max and the 90th percentile) within rtol 1e-6;
* the scales artifact: JAX -> port and port -> JAX, the same values and
  the same sha256;
* the int8 model on JAX's own folded params and scales: logits within
  rtol 1e-6 plus 1e-6 of the largest |logit| (a float32 rounding
  difference upstream moves a logit near 0 by more than rtol alone);
  the logits are JAX's op-by-op run (`apply` outside `jit`);
* Detections against JAX's jitted predict. Inside `jit` XLA fuses the
  input normalization and the rescales and rounds them otherwise, so
  some activations quantize a level apart from its own op-by-op run and
  the logits of this tiny random model move by up to ~0.012 (a score by
  ~3e-3, enough to move a peak among near-equal neighbours); an int8
  weight a level apart does the same. So: the port's int8 predict on
  JAX's folded params against JAX's predict over its int8 twin on the
  same params, and the port's int8 predict against JAX's int8 predict,
  each with its own fold (residual, ghost, depthwise; at most 1e-4 of
  the int8 weights one level apart and none further): detections >= 0.1
  matched both ways with the same class, |score difference| <= 1e-2 and
  IoU >= 0.99 or corners within one 4-pixel output cell, at least 95% of
  them each way (hard NMS between the near-equal random boxes of this
  model keeps the other box of a pair when two scores swap order; the
  float path matches all of them at 1e-3, and so do the variants whose
  activations and weights quantize alike, ghost and depthwise, here);
* the guards of the JAX package's quant tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu.models.hourglass import \
    QuantConv as JaxQuantConv
from real_time_helmet_detection_tpu.ops import quant as jq
from real_time_helmet_detection_tpu.predict import \
    make_predict_fn as jax_make_predict_fn
from real_time_helmet_detection_tpu_torch import convert
from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.models.hourglass import (
    QuantConv, build_model)
from real_time_helmet_detection_tpu_torch.ops import qconv
from real_time_helmet_detection_tpu_torch.ops import quant as pq
from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
from test_torch_predict import _iou, bn_scaled
from test_torch_predict import rows as _rows
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

ARCH = dict(imsize=64, hourglass_inch=32, num_cls=2)


@pytest.fixture(scope="module")
def states():
    """{variant: (jax cfg, jax model, variables with random BN, images
    normal(0, 1) (2, 64, 64, 3))}, built on first use."""
    cache = {}

    def get(variant):
        if variant not in cache:
            jcfg = JaxConfig(epilogue="xla", block_fuse="xla",
                             variant=variant, **ARCH)
            model = jax_build(jcfg)
            images = np.random.default_rng(0).normal(
                0, 1, (2, 64, 64, 3)).astype(np.float32)
            v = jax.jit(model.init, static_argnames=("train",))(
                jax.random.key(0), jnp.asarray(images), train=False)
            cache[variant] = (jcfg, model, bn_scaled(jax.device_get(v), 1),
                              images)
        return cache[variant]
    return get


def port_cfg(variant="residual", **kw):
    return Config(device="cpu", variant=variant, **ARCH, **kw)


def ulps(a, b, scale):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.spacing(np.asarray(scale, np.float32))


# ---------------------------------------------------------------- the fold


@pytest.mark.parametrize("variant", ["residual", "ghost", "depthwise"])
def test_fold_within_ulps_of_jax(states, variant):
    _, _, v, _ = states(variant)
    theirs = convert.flatten_tree(jax.device_get(
        jq.fold_batchnorm(v["params"], v["batch_stats"])))
    ours = convert.flatten_tree(pq.fold_batchnorm(v["params"],
                                                  v["batch_stats"]))
    assert ours.keys() == theirs.keys()
    params = convert.flatten_tree(v["params"])
    stats = convert.flatten_tree(v["batch_stats"])
    folded = 0
    for key, want in theirs.items():
        got = ours[key]
        assert np.asarray(got).dtype == np.float32
        base = key.rsplit("Conv_0/", 1)[0]
        bn = base + "BatchNorm_0/"
        if bn + "scale" not in params:  # never had a BN: passed through
            np.testing.assert_array_equal(got, want)
            continue
        folded += 1
        if key.endswith("kernel"):
            assert ulps(got, want, np.abs(want)).max() <= 3, key
        else:
            inv = params[bn + "scale"] / np.sqrt(
                stats[bn + "var"].astype(np.float64) + 1e-5)
            cb = params.get(base + "Conv_0/bias", 0.0)
            terms = np.maximum(np.abs((cb - stats[bn + "mean"]) * inv),
                               np.abs(params[bn + "bias"]))
            assert ulps(got, want, terms).max() <= 4, key
    assert folded > 10


def test_fold_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="Conv_0 sibling"):
        pq.fold_batchnorm({"BatchNorm_0": {}}, {})
    with pytest.raises(ValueError, match="mean/var"):
        pq.fold_batchnorm({"Conv_0": {"kernel": np.ones((1, 1, 1, 2))},
                           "BatchNorm_0": {}}, {"BatchNorm_0": {}})


# ---------------------------------------------------------- the quantizers


def awkward(shape, seed):
    """Normal values with exact .5 ties, +-inf, NaN and far outliers."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[:40] = np.arange(-20, 20, dtype=np.float32) + 0.5
    flat[40:44] = [np.inf, -np.inf, np.nan, 1e30]
    flat[44] = -1e30
    return x


def test_quantize_weights_equal_jax():
    kernel = awkward((3, 3, 16, 24), 1)  # HWIO
    kernel[np.isnan(kernel) | np.isinf(kernel)] = 0.0
    kernel[..., 5] = 0.0                 # a dead channel: the floor
    q_j, s_j = (np.asarray(t) for t in jq.quantize_weights(kernel))
    q_p, s_p = pq.quantize_weights(torch.from_numpy(
        kernel.transpose(3, 2, 0, 1).copy()))  # OIHW
    np.testing.assert_array_equal(s_p.numpy(), s_j)
    np.testing.assert_array_equal(q_p.numpy().transpose(2, 3, 1, 0), q_j)


@pytest.mark.parametrize("absmax", [3.0, 0.0, 1e-3])
def test_quantize_activations_equal_jax(absmax):
    x = awkward((2, 5, 7, 16), 2) * np.float32(max(absmax, 1e-3))
    q_j, s_j = (np.asarray(t) for t in jq.quantize_activations(x, absmax))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels-last NCHW view
    q_p, s_p = pq.quantize_activations(xt, absmax)
    assert float(s_p) == float(s_j)
    np.testing.assert_array_equal(q_p.permute(0, 2, 3, 1).numpy(), q_j)
    # the wrapper takes the same path for a CPU tensor
    np.testing.assert_array_equal(
        qconv.quantize_act(xt, s_p).permute(0, 2, 3, 1).numpy(), q_j)


# ---------------------------------------------------------------- QuantConv

CONVS = {"dense3x3": (32, 24, 3, 1), "dense1x1": (32, 16, 1, 1),
         "depthwise": (16, 16, 3, 16)}


def conv_case(name, seed=3):
    cin, cout, k, groups = CONVS[name]
    rng = np.random.default_rng(seed)
    kernel = rng.normal(0, 0.3, (k, k, cin // groups, cout)).astype(
        np.float32)
    bias = rng.normal(0, 0.5, (cout,)).astype(np.float32)
    x = np.maximum(rng.normal(0, 1, (2, 9, 7, cin)), -0.3).astype(np.float32)
    return kernel, bias, np.float32(2.5), x


def port_quantconv(name, kernel, bias, clip):
    cin, cout, k, groups = CONVS[name]
    m = QuantConv(cin, cout, k, groups, "int8")
    m.load_state_dict({"weight": torch.from_numpy(
        kernel.transpose(3, 2, 0, 1).copy()),
        "bias": torch.from_numpy(bias), "act_scale": torch.tensor(clip)})
    m.requantize()
    return m


@pytest.mark.parametrize("name", list(CONVS))
def test_quantconv_int32_sums_equal_jax(name):
    kernel, bias, clip, x = conv_case(name)
    cin, cout, k, groups = CONVS[name]
    xq, _ = jq.quantize_activations(x, clip)
    wq, _ = jq.quantize_weights(kernel)
    acc_j = np.asarray(jax.lax.conv_general_dilated(
        xq, wq, (1, 1), ((k // 2, k // 2),) * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32, feature_group_count=groups))
    m = port_quantconv(name, kernel, bias, clip)
    q = qconv.quantize_act(torch.from_numpy(x).permute(0, 3, 1, 2), m.step)
    if m.depthwise:
        acc_p = qconv.conv_dw(q, m.weight_q, m.mult, m.bias, torch.int32)
    else:
        acc_p = qconv.conv_dense(q, m.weight_q.view(cout, k, k, cin),
                                 m.mult, m.bias, torch.int32)
    assert acc_p.dtype == torch.int32
    np.testing.assert_array_equal(acc_p.permute(0, 2, 3, 1).numpy(), acc_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["Linear", "ReLU"])
@pytest.mark.parametrize("name", list(CONVS))
def test_quantconv_output_matches_jax(name, act, dtype):
    kernel, bias, clip, x = conv_case(name)
    cin, cout, k, groups = CONVS[name]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x).astype(jdt)
    qc = JaxQuantConv(cout, kernel_size=k, padding=k // 2, groups=groups,
                      mode="int8", dtype=jdt)
    y_j = qc.apply({"params": {"kernel": kernel, "bias": bias},
                    "quant": {"act_scale": clip}}, xj)
    if act == "ReLU":
        y_j = jax.nn.relu(y_j)
    y_j = np.asarray(y_j.astype(jnp.float32))
    m = port_quantconv(name, kernel, bias, clip)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    y_p = m(xt, act)
    assert y_p.dtype == getattr(torch, dtype)
    assert y_p.is_contiguous(memory_format=torch.channels_last)
    y_p = y_p.float().permute(0, 2, 3, 1).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(y_p, y_j, rtol=1e-6, atol=1e-30)
    else:
        _, e = np.frexp(y_j)
        ulp = np.ldexp(np.ones_like(y_j), e - 8)
        assert (np.abs(y_p - y_j) <= ulp).all()


# -------------------------------------------------------------- calibration


@pytest.mark.parametrize("percentile", [100.0, 90.0])
@pytest.mark.parametrize("variant", ["residual", "ghost"])
def test_calibration_matches_jax(states, variant, percentile):
    jcfg, _, v, _ = states(variant)
    theirs = convert.flatten_tree(jq.calibrate_scales(
        jcfg, v, jq.synthetic_calibration_batches(2, 64, n=2, raw=True),
        normalize="imagenet", percentile=percentile))
    ours = convert.flatten_tree(pq.calibrate_scales(
        port_cfg(variant), v,
        pq.synthetic_calibration_batches(2, 64, n=2, raw=True),
        normalize="imagenet", percentile=percentile, device="cpu"))
    assert ours.keys() == theirs.keys()
    assert all(k.endswith("Conv_0/act_scale") for k in ours)
    for key in ours:
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-6)


def test_percentile_matches_numpy_linear_rule():
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (3, 5, 7, 11)).astype(np.float32))
    for p in (90.0, 99.9, 50.0, 100.0):
        want = np.percentile(np.abs(x.numpy()), p)
        np.testing.assert_allclose(float(pq.abs_percentile(x, p)), want,
                                   rtol=1e-6)


def test_calibration_percentile_tightens_scales(states):
    _, _, v, _ = states("residual")
    batches = list(pq.synthetic_calibration_batches(2, 64, n=2))
    s_max = convert.flatten_tree(pq.calibrate_scales(
        port_cfg(), v, iter(batches), device="cpu"))
    s_p90 = convert.flatten_tree(pq.calibrate_scales(
        port_cfg(), v, iter(batches), percentile=90.0, device="cpu"))
    hi = np.array([s_max[k] for k in sorted(s_max)])
    lo = np.array([s_p90[k] for k in sorted(s_max)])
    assert (lo <= hi + 1e-7).all() and (lo < hi - 1e-7).any()


# ------------------------------------------------------------ the artifact


def test_scales_artifact_round_trips_both_ways(states, tmp_path):
    jcfg, _, v, _ = states("residual")
    scales = jq.calibrate_scales(jcfg, v,
                                 jq.synthetic_calibration_batches(2, 64))
    jpath, ppath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    digest = jq.save_scales(jpath, scales, meta={"calib_batches": 2})
    loaded = pq.load_scales(jpath)
    assert pq.scales_hash(loaded) == digest == jq.scales_hash(scales)
    flat = convert.flatten_tree(loaded)
    assert flat == {k: np.float32(x) for k, x in
                    convert.flatten_tree(jax.device_get(scales)).items()}
    assert all(np.asarray(x).dtype == np.float32 for x in flat.values())
    assert pq.save_scales(ppath, loaded, meta={"calib_batches": 2}) \
        == digest
    back = jq.load_scales(ppath)
    assert jq.scales_hash(back) == digest
    with open(jpath) as f, open(ppath) as g:
        assert f.read() == g.read()
    (tmp_path / "bad.json").write_text('{"format": "other"}')
    with pytest.raises(ValueError, match="quant-scales-v1"):
        pq.load_scales(str(tmp_path / "bad.json"))


# ----------------------------------------------------------- int8 predict


def twin_from_jax_fold(variant, v, scales):
    folded = jax.device_get(jq.fold_batchnorm(v["params"], v["batch_stats"]))
    twin = build_model(port_cfg(variant), fold_bn=True, quant_mode="int8")
    convert.load_into(twin, {"params": folded, "quant": scales})
    pq.requantize(twin)
    return twin.eval(), folded


@pytest.mark.parametrize("variant", ["residual", "ghost", "depthwise"])
def test_int8_logits_from_jax_fold_match_jax(states, variant):
    jcfg, _, v, images = states(variant)
    scales = jq.calibrate_scales(jcfg, v,
                                 jq.synthetic_calibration_batches(2, 64))
    twin, folded = twin_from_jax_fold(variant, v, scales)
    qmodel = jq.make_quant_model(jcfg, mode="int8")
    want = np.asarray(qmodel.apply({"params": folded, "quant": scales},
                                   jnp.asarray(images), train=False))
    with torch.inference_mode():
        got = twin(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def match_share(a, b, min_score=0.1, score_tol=1e-3, corner_tol=1e-2):
    """(detections >= min_score of `a` that have one in `b` with the same
    class, |score difference| <= score_tol and IoU >= 0.99 or every
    corner within corner_tol, detections checked)."""
    hit = checked = 0
    for (ab, ac, as_), (bb, bc, bs) in zip(a, b):
        sel = bs >= min_score - score_tol
        bb, bc, bs = bb[sel], bc[sel], bs[sel]
        for box, c, s in zip(ab, ac, as_):
            if s < min_score:
                continue
            checked += 1
            close = (_iou(box, bb) >= 0.99) | (
                np.abs(bb - box).max(axis=1, initial=0) <= corner_tol)
            hit += bool(((bc == c) & (np.abs(bs - s) <= score_tol)
                         & close).any())
    return hit, checked


def assert_matched_both_ways(a, b, share=0.95, **tol):
    for x, y in ((a, b), (b, a)):
        hit, checked = match_share(x, y, **tol)
        assert checked > 0 and hit >= share * checked, (hit, checked)


@pytest.mark.parametrize("variant", ["residual", "ghost"])
def test_int8_detections_from_jax_fold_match_jax(states, variant):
    jcfg, _, v, _ = states(variant)
    scales = jq.calibrate_scales(jcfg, v,
                                 jq.synthetic_calibration_batches(2, 64))
    images = np.random.default_rng(5).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    twin, folded = twin_from_jax_fold(variant, v, scales)
    fresh = convert.load_into(build_model(port_cfg(variant)), v)
    predict = make_predict_fn(fresh, port_cfg(variant, infer_dtype="int8"),
                              normalize="imagenet", device="cpu",
                              quant_scales=scales)
    predict.load({"params": v["params"], "batch_stats": v["batch_stats"]},
                 scales)
    predict.model.load_state_dict(twin.state_dict())  # JAX's fold
    pq.requantize(predict.model)
    ours = _rows(predict(images))
    # JAX's predict over its int8 twin, fed the same folded params
    qmodel = jq.make_quant_model(jcfg, mode="int8")
    theirs = _rows(jax.device_get(jax_make_predict_fn(
        qmodel, jcfg, normalize="imagenet")(
            {"params": folded, "quant": scales}, jnp.asarray(images))))
    assert_matched_both_ways(ours, theirs, score_tol=1e-2, corner_tol=4.0)


@pytest.mark.parametrize("variant", ["residual", "ghost", "depthwise"])
def test_int8_predict_own_fold_matches_jax(states, variant):
    jcfg, model, v, _ = states(variant)
    scales = jq.calibrate_scales(
        jcfg, v, jq.synthetic_calibration_batches(2, 64, raw=True),
        normalize="imagenet")
    images = np.random.default_rng(6).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    fresh = convert.load_into(build_model(port_cfg(variant)), v)
    predict = make_predict_fn(fresh, port_cfg(variant, infer_dtype="int8"),
                              normalize="imagenet", device="cpu",
                              quant_scales=scales)
    # int8 weights: each side's own fold, quantized
    folded = convert.flatten_tree(jax.device_get(
        jq.fold_batchnorm(v["params"], v["batch_stats"])))
    mods = pq.quant_modules(predict.model)
    apart, total = 0, 0
    for path, m in mods.items():
        want, _ = jq.quantize_weights(folded[path + "/kernel"])
        want = np.asarray(want).transpose(3, 0, 1, 2)  # (Cout, k, k, Cin)
        got = m.weight_q.numpy()
        got = (got.T.reshape(want.shape) if m.depthwise
               else got.reshape(want.shape))
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1, path
        apart += int((diff == 1).sum())
        total += diff.size
    assert apart <= 1e-4 * total, (apart, total)
    ours = _rows(predict(images))
    theirs = _rows(jax.device_get(jax_make_predict_fn(
        model, dataclasses.replace(jcfg, infer_dtype="int8"),
        normalize="imagenet", quant_scales=scales)(v, jnp.asarray(images))))
    assert_matched_both_ways(ours, theirs, score_tol=1e-2, corner_tol=4.0)


# -------------------------------------------------------------- the guards


def test_predict_int8_requires_scales():
    model = build_model(port_cfg())
    with pytest.raises(ValueError, match="quant_scales"):
        make_predict_fn(model, port_cfg(infer_dtype="int8"), device="cpu")


def test_build_model_quant_requires_fold():
    with pytest.raises(ValueError, match="fold_bn"):
        build_model(port_cfg(), quant_mode="int8")
    with pytest.raises(ValueError, match="quant_mode"):
        build_model(port_cfg(), fold_bn=True, quant_mode="int4")


def test_twin_state_dict_is_the_flax_fold_layout(states):
    """The twin's state dict is the folded params + quant tree under the
    flax paths: the bridge maps JAX's fold and scales onto every leaf,
    and back."""
    jcfg, _, v, _ = states("ghost")
    scales = jq.calibrate_scales(jcfg, v,
                                 jq.synthetic_calibration_batches(2, 64))
    twin, folded = twin_from_jax_fold("ghost", v, scales)
    tree = convert.state_dict_to_flax(twin.state_dict())
    assert sorted(tree) == ["params", "quant"]
    assert convert.flatten_tree(tree["quant"]).keys() \
        == convert.flatten_tree(jax.device_get(scales)).keys()
    assert convert.flatten_tree(tree["params"]).keys() \
        == convert.flatten_tree(folded).keys()
    # no BatchNorm and no BN kernel site is left in the twin
    assert not any("BatchNorm" in k for k in twin.state_dict())
    n_quant = len(pq.quant_modules(twin))
    n_bn = sum(k.endswith("BatchNorm_0/scale")
               for k in convert.flatten_tree(v["params"]))
    assert n_quant == n_bn - 1  # every BN'd conv but the stem
