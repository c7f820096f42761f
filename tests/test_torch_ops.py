"""The PyTorch port's kernel modules, decode and NMS against the JAX package.

Same numpy inputs (seeded) through the JAX function and the port's
counterpart, on the CPU: the port's wrappers run their plain versions
for CPU tensors; the JAX side runs the Pallas kernels in interpret mode
and their jnp twins, as the JAX suite does. Tolerances:

* epilogue / residual tail: atol 1e-6 in f32 (the same f32 formula);
  Mish adds rtol 1e-6 (about 8 ulps), because XLA:CPU computes tanh by
  a polynomial a few ulps off libm's, and the port's softplus is
  log1p(exp(z)) where JAX's is logaddexp(z, 0);
* peak test: masks identical, scores rtol 1e-6 (sigmoid rounding); with
  NaN and +-inf logits, exactly equal (NaN-aware) wherever the two
  libraries' sigmoids agree, rtol 1e-6 on the few cells where they
  differ by their last bit;
* decode: indices, classes and valid exactly equal (tie order included),
  boxes atol 1e-4;
* NMS: keep masks identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu.ops.decode import \
    decode_peak_scores as jax_decode_peak_scores
from real_time_helmet_detection_tpu.ops.nms import nms_mask as jax_nms_mask
from real_time_helmet_detection_tpu.ops.pallas.epilogue import fused_bn_act
from real_time_helmet_detection_tpu.ops.pallas.peak import (
    fused_peak_scores, peak_scores_reference)
from real_time_helmet_detection_tpu.ops.pallas.residual import \
    fused_bn_add_act
from real_time_helmet_detection_tpu_torch.ops import (decode, epilogue, nms,
                                                      peak, residual)
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

ACTS = ("ReLU", "Mish", "Linear")
RTOL = {"ReLU": 0.0, "Linear": 0.0, "Mish": 1e-6}


def nhwc_to_port(x: np.ndarray) -> torch.Tensor:
    """(N, H, W, C) numpy -> the port's NCHW channels-last view (no copy)."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def port_to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def affine(rng, c):
    return (rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.normal(0, 0.5, c).astype(np.float32))


@pytest.mark.parametrize("act", ACTS)
def test_bn_act_matches_jax(act):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 8, 8, 16)).astype(np.float32)
    a, b = affine(rng, 16)
    got = port_to_nhwc(epilogue.bn_act(nhwc_to_port(x), torch.from_numpy(a),
                                       torch.from_numpy(b), act))
    for interpret in (True, None):  # Pallas interpret, jnp twin
        want = np.asarray(fused_bn_act(jnp.asarray(x), jnp.asarray(a),
                                       jnp.asarray(b), activation=act,
                                       interpret=interpret))
        np.testing.assert_allclose(got, want, rtol=RTOL[act], atol=1e-6)


@pytest.mark.parametrize("act", ACTS)
def test_bn_add_act_matches_jax(act):
    rng = np.random.default_rng(1)
    y = rng.normal(0, 2, (2, 8, 8, 16)).astype(np.float32)
    s = rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32)
    a, b = affine(rng, 16)
    got = port_to_nhwc(residual.bn_add_act(
        nhwc_to_port(y), torch.from_numpy(a), torch.from_numpy(b),
        nhwc_to_port(s), act))
    for interpret in (True, None):
        want = np.asarray(fused_bn_add_act(
            jnp.asarray(y), jnp.asarray(a), jnp.asarray(b), jnp.asarray(s),
            activation=act, interpret=interpret))
        np.testing.assert_allclose(got, want, rtol=RTOL[act], atol=1e-6)


def test_bf16_plain_versions_round_once_from_f32():
    """bf16 storage: f32 math, one rounding at the store."""
    rng = np.random.default_rng(2)
    x = nhwc_to_port(rng.normal(0, 2, (1, 4, 4, 8)).astype(np.float32))
    s = nhwc_to_port(rng.normal(0, 1, (1, 4, 4, 8)).astype(np.float32))
    a, b = (torch.from_numpy(v) for v in affine(rng, 8))
    xb = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    sb = s.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    for act in ACTS:
        got = epilogue.bn_act(xb, a, b, act)
        assert got.dtype == torch.bfloat16
        assert got.is_contiguous(memory_format=torch.channels_last)
        want = epilogue.activate(xb.float() * a.view(1, -1, 1, 1)
                                 + b.view(1, -1, 1, 1), act)
        assert torch.equal(got, want.to(torch.bfloat16))
        got = residual.bn_add_act(xb, a, b, sb, act)
        want = epilogue.activate(xb.float() * a.view(1, -1, 1, 1)
                                 + b.view(1, -1, 1, 1) + sb.float(), act)
        assert torch.equal(got, want.to(torch.bfloat16))


def test_wrappers_refuse_bad_inputs():
    x = torch.zeros(1, 4, 2, 2)  # NCHW-contiguous, not channels-last
    a, b = torch.ones(4), torch.zeros(4)
    with pytest.raises(ValueError, match="channels_last"):
        epilogue.bn_act(x, a, b, "ReLU")
    xc = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(NotImplementedError):
        epilogue.bn_act(xc, a, b, "CELU")
    with pytest.raises(ValueError, match="eff_scale"):
        epilogue.bn_act(xc, torch.ones(3), b, "ReLU")
    with pytest.raises(TypeError):
        epilogue.bn_act(xc.half(), a, b, "ReLU")
    with pytest.raises(ValueError, match="skip"):
        residual.bn_add_act(xc, a, b, xc.to(torch.bfloat16), "ReLU")
    # a meta tensor (the layer table's shape inference) takes the op's
    # fake: its shape, no launch, no error
    out = epilogue.bn_act(xc.to("meta"), a.to("meta"), b.to("meta"), "ReLU")
    assert out.device.type == "meta" and out.shape == xc.shape
    with pytest.raises(ValueError, match="pool_size"):
        peak.peak_scores(torch.zeros(1, 1, 4, 4, 6), 2, pool_size=4)
    assert epilogue.launches == residual.launches == peak.launches == 0


@pytest.mark.parametrize("pool_size", [1, 3, 5])
def test_peak_scores_matches_jax(pool_size):
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 3, (2, 2, 16, 16, 6)).astype(np.float32)
    got = peak.peak_scores(torch.from_numpy(logits), 2, pool_size).numpy()
    assert got.shape == (2, 2, 2, 16, 16)
    for b in range(2):
        for s in range(2):
            heat = jnp.asarray(logits[b, s, ..., :2])
            for want in (fused_peak_scores(heat, interpret=True,
                                           pool_size=pool_size),
                         peak_scores_reference(heat, pool_size)):
                want = np.asarray(want).transpose(2, 0, 1)
                np.testing.assert_array_equal(got[b, s] > 0, want > 0)
                np.testing.assert_allclose(got[b, s], want, rtol=1e-6,
                                           atol=0)


def _sprinkle(rng, x, share):
    """x with a `share` of its values each set to NaN, +inf and -inf."""
    u = rng.random(x.shape)
    x = x.copy()
    x[u < share] = np.nan
    x[(u >= share) & (u < 2 * share)] = np.inf
    x[(u >= 2 * share) & (u < 3 * share)] = -np.inf
    return x


@pytest.mark.parametrize("pool_size", [1, 3, 5])
def test_peak_scores_nan_inf_match_jax(pool_size):
    """A diverged model's logits: NaN and +-inf among them. A window that
    holds a NaN has a NaN max in JAX's `reduce_window` (the reference),
    in the Pallas kernel's `jnp.maximum` (interpret mode) and in the
    port's `F.max_pool2d`, so every cell within reach of a NaN is 0, the
    NaN cell too; +inf and -inf logits are scores 1 and 0. The port's
    output equals both NaN-aware, bit for bit wherever the two
    libraries' sigmoids agree."""
    rng = np.random.default_rng(11)
    logits = _sprinkle(rng, rng.normal(0, 3, (2, 2, 16, 16, 6))
                       .astype(np.float32), 0.02)
    got = peak.peak_scores(torch.from_numpy(logits), 2, pool_size).numpy()
    heat = logits[..., :2]
    sig_same = torch.sigmoid(torch.from_numpy(heat)).numpy() == np.asarray(
        jax.nn.sigmoid(jnp.asarray(heat)))
    near_nan = torch.nn.functional.max_pool2d(
        torch.from_numpy(np.isnan(heat).astype(np.float32))
        .permute(0, 1, 4, 2, 3).flatten(0, 1), pool_size, 1,
        pool_size // 2).unflatten(0, (2, 2)).numpy() > 0
    assert near_nan.any() and np.isinf(heat).any()
    assert not np.isnan(got).any()
    assert (got[near_nan] == 0).all()
    for b in range(2):
        for s in range(2):
            h = jnp.asarray(logits[b, s, ..., :2])
            for want in (fused_peak_scores(h, interpret=True,
                                           pool_size=pool_size),
                         peak_scores_reference(h, pool_size)):
                want = np.asarray(want).transpose(2, 0, 1)
                same = sig_same[b, s].transpose(2, 0, 1)
                np.testing.assert_array_equal(np.isnan(got[b, s]),
                                              np.isnan(want))
                np.testing.assert_array_equal(got[b, s] > 0, want > 0)
                np.testing.assert_array_equal(got[b, s][same], want[same])
                np.testing.assert_allclose(got[b, s], want, rtol=1e-6,
                                           atol=0)


def test_peak_scores_plateau_ties_count():
    logits = np.zeros((1, 1, 6, 6, 6), np.float32)
    logits[0, 0, 2:4, 2:4, 0] = 2.0  # a 2x2 plateau: every cell a peak
    got = peak.peak_scores(torch.from_numpy(logits), 2).numpy()[0, 0, 0]
    assert (got[2:4, 2:4] > 0).all()
    # the plateau's neighbours lose; the flat far corner ties with itself
    assert got[1, 1] == 0.0 and got[2, 4] == 0.0
    assert got[5, 5] == 0.5


def _decode_inputs(rng, tied=False):
    peaks_hwc = np.where(rng.random((16, 16, 2)) < 0.1,
                         rng.random((16, 16, 2)), 0.0).astype(np.float32)
    if tied:  # many equal non-zero scores: the tie order must agree
        peaks_hwc = np.where(peaks_hwc > 0, 0.5, 0.0).astype(np.float32)
    offset = rng.random((16, 16, 2)).astype(np.float32)
    wh = rng.uniform(1, 8, (16, 16, 2)).astype(np.float32)
    return peaks_hwc, offset, wh


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("normalized", [False, True])
def test_decode_peak_scores_matches_jax(tied, normalized):
    rng = np.random.default_rng(4)
    items = [_decode_inputs(rng, tied) for _ in range(3)]
    peaks = torch.from_numpy(np.stack([p.transpose(2, 0, 1)
                                       for p, _, _ in items]))
    offset = torch.from_numpy(np.stack([o for _, o, _ in items]))
    wh = torch.from_numpy(np.stack([w for _, _, w in items]))
    got = decode.decode_peak_scores(peaks, offset, wh, topk=100,
                                    conf_th=0.0, normalized=normalized)
    for i, (p, o, w) in enumerate(items):
        want = jax_decode_peak_scores(jnp.asarray(p), jnp.asarray(o),
                                      jnp.asarray(w), topk=100, conf_th=0.0,
                                      normalized=normalized)
        np.testing.assert_array_equal(got.scores[i].numpy(),
                                      np.asarray(want.scores))
        np.testing.assert_array_equal(got.classes[i].numpy(),
                                      np.asarray(want.classes))
        np.testing.assert_array_equal(got.valid[i].numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_allclose(got.boxes[i].numpy(),
                                   np.asarray(want.boxes), rtol=0, atol=1e-4)
        # the zero-score fillers are valid at conf_th 0 and in index order
        assert (got.scores[i] == 0).any()


def test_decode_heatmap_is_peak_path():
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.normal(0, 3, (2, 1, 16, 16, 6))
                              .astype(np.float32))
    heat = torch.sigmoid(logits[..., :2]).permute(0, 1, 4, 2, 3)
    off, wh = logits[..., 2:4], logits[..., 4:6]
    a = decode.decode_heatmap(heat, off, wh, topk=50, conf_th=0.0)
    b = decode.decode_peak_scores(peak.peak_scores(logits, 2), off, wh,
                                  topk=50, conf_th=0.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _nms_case(rng, n, kind):
    xy = rng.uniform(0, 40, (n, 2))
    size = rng.uniform(4, 20, (n, 2))
    boxes = np.concatenate([xy, xy + size], 1).astype(np.float32)
    scores = rng.random(n).astype(np.float32)
    valid = rng.random(n) < 0.8
    if kind == "ties":  # clustered duplicates with equal scores
        boxes[n // 2:] = boxes[:n - n // 2] + rng.uniform(
            -1, 1, (n - n // 2, 4)).astype(np.float32)
        scores = np.round(scores * 3) / 3
    elif kind == "invalid":
        valid[:] = False
    return boxes, scores.astype(np.float32), valid


@pytest.mark.parametrize("kind", ["random", "ties", "invalid"])
def test_nms_mask_matches_jax(kind):
    rng = np.random.default_rng(6)
    cases = [_nms_case(rng, 64, kind) for _ in range(3)]
    boxes, scores, valid = (np.stack(x) for x in zip(*cases))
    got = nms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                       torch.from_numpy(valid), 0.5).numpy()
    for i in range(3):
        want = np.asarray(jax_nms_mask(jnp.asarray(boxes[i]),
                                       jnp.asarray(scores[i]),
                                       jnp.asarray(valid[i]), 0.5))
        np.testing.assert_array_equal(got[i], want)
    if kind == "invalid":
        assert not got.any()
    else:
        assert 0 < got.sum() < valid.sum()
