"""The int8 convs' code outputs, the quantizer at two steps and the
abs-max (csrc/qconv.cu), on the CPU through their plain versions:

* a conv's code outputs: the `helmet` op's plain version, float32 and
  bfloat16, dense 1x1 and 3x3 and depthwise, writes its float output
  and the codes of that output at a channel offset into a wider int8
  tensor, both bit-equal to `conv_*_reference` followed by
  `quantize_act_reference`, with ties at .5, +-inf, saturation and NaN
  among the outputs; the wider tensor's other channels stay as they
  were; two code outputs at once and no float output; the wrappers'
  refusals;
* the int8 twin whose convs write their consumers' codes
  (`Residual.fuse_codes`) against the same twin with every block
  unfused, on the throughput tier's ghost architecture (width 96) and
  on the residual variant at 64^2: logits and Detections bit-equal,
  the quantizer called 18 times (19 sites) where the unfused twin calls
  it 70 and 36 times; and the throughput tier's fused logits against
  JAX's int8 twin on JAX's fold within tests/test_torch_quant.py's
  rule (rtol 1e-6 plus 1e-6 of the largest |logit|);
* the quantizer at two steps equal to two quantizations;
* the abs-max's plain version equal to `x.abs().amax()`, NaN, +-inf and
  -0.0 among the inputs, and the STE forward's step bit-equal to
  `act_step` of it;
* the count (`obs.roofline.OpCount`) of a fused int8 forward: each int8
  conv's row holds the codes it writes (its Cout channels of each code
  output), not the wider tensor, and its FLOPs whether or not it stores
  a float output.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu.ops import quant as jq
from real_time_helmet_detection_tpu_torch import convert
from real_time_helmet_detection_tpu_torch.config import Config, apply_tier
from real_time_helmet_detection_tpu_torch.models.hourglass import (
    Residual, build_model)
from real_time_helmet_detection_tpu_torch.ops import qconv
from real_time_helmet_detection_tpu_torch.ops import quant as pq
from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
from test_torch_predict import bn_scaled, chip_smoke
from test_torch_predict import rows as _rows
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)


def cl(t):
    return t.contiguous(memory_format=torch.channels_last)


def same(a, b):
    """Bit-equal values, NaN where the other has NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, torch.zeros_like(a), a),
        torch.where(nan, torch.zeros_like(b), b))


def conv_operands(kind, k, dtype, seed=0):
    """An int8 input (2, 16, 5, 7), weights, and a mult/bias whose outputs
    hold exact ties at .5 of the step 0.5 (mult 0.25, odd sums), +-inf
    and NaN (from the bias) and values past +-127 steps (mult 100)."""
    gen = torch.Generator().manual_seed(seed)
    c = 16
    q = cl(torch.randint(-8, 9, (2, c, 5, 7), generator=gen,
                         dtype=torch.int8))
    cout = c if kind == "dw" else 24
    w = torch.randint(-3, 4, (9, c) if kind == "dw" else (cout, k, k, c),
                      generator=gen, dtype=torch.int8)
    mult = torch.full((cout,), 0.25)
    mult[1::4] = 100.0
    bias = torch.zeros(cout)
    bias[2], bias[3], bias[5] = float("inf"), float("-inf"), float("nan")
    return q, w, mult, bias


CONVS = {"dense1": ("dense", 1), "dense3": ("dense", 3), "dw": ("dw", 3)}


@pytest.mark.parametrize("store", [True, False])
@pytest.mark.parametrize("act", ["ReLU", "Linear"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CONVS))
def test_conv_codes_equal_conv_then_quantize(name, dtype, act, store):
    kind, k = CONVS[name]
    q, w, mult, bias = conv_operands(kind, k, dtype)
    conv = qconv.conv_dw if kind == "dw" else qconv.conv_dense
    ref = qconv.conv_dw_reference if kind == "dw" else \
        qconv.conv_dense_reference
    cout = mult.shape[0]
    want = ref(q, w, mult, bias, dtype, act)
    step, step2 = torch.tensor(0.5), torch.tensor(0.0137)
    # the first output at channel 8 of 8 + cout + 16, the second alone
    wide = cl(torch.full((2, cout + 24, 5, 7), 55, dtype=torch.int8))
    other = cl(torch.full((2, cout, 5, 7), -9, dtype=torch.int8))
    got = conv(q, w, mult, bias, dtype, act, store,
               [(wide, step, 8), (other, step2, 0)])
    if store:
        assert same(got, want)
    else:
        assert got is None
    codes = qconv.quantize_act_reference(want, step)
    assert torch.equal(wide[:, 8:8 + cout], codes)
    assert torch.equal(other, qconv.quantize_act_reference(want, step2))
    assert bool((wide[:, :8] == 55).all() and (wide[:, 8 + cout:] == 55)
                .all())
    # the outputs do hold what the quantizer's rule is tested on
    ratio = want.float() / step
    finite = torch.isfinite(ratio)
    assert bool((ratio[finite].abs() > 127).any())
    assert bool((ratio[finite] - ratio[finite].floor() == 0.5).any())
    assert bool(torch.isnan(want).any())
    assert bool((codes[torch.isnan(want)] == 0).all())
    assert bool((codes[want == float("inf")] == 127).all())


def test_conv_codes_refusals():
    q, w, mult, bias = conv_operands("dense", 1, torch.float32)
    step = torch.tensor(0.5)

    def codes(ch, dtype=torch.int8, hw=(5, 7)):
        return cl(torch.zeros((2, ch) + hw, dtype=dtype))
    for kw, err in (
            (dict(codes=[(codes(24), step, 0)] * 3), ValueError),
            (dict(codes=[(codes(30), step, 8)]), ValueError),  # no room
            (dict(codes=[(codes(24, hw=(5, 6)), step, 0)]), ValueError),
            (dict(codes=[(codes(24, torch.int32), step, 0)]), ValueError),
            (dict(codes=[(codes(24), torch.tensor([0.5]), 0)]), ValueError),
            (dict(store=False), ValueError)):
        with pytest.raises(err):
            qconv.conv_dense(q, w, mult, bias, torch.float32, "Linear", **kw)
    with pytest.raises(ValueError):  # int32 sums have no codes
        qconv.conv_dense(q, w, mult, bias, torch.int32, "Linear",
                         codes=[(codes(24), step, 0)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_at_two_steps(dtype):
    gen = torch.Generator().manual_seed(1)
    x = cl((torch.randn((2, 16, 5, 7), generator=gen) * 3).to(dtype))
    flat = x.permute(0, 2, 3, 1).view(-1)  # x's storage, in order
    flat[:4] = torch.tensor([float("nan"), float("inf"), float("-inf"),
                             0.125]).to(dtype)
    s1, s2 = torch.tensor(0.25), torch.tensor(0.013)
    a, b = qconv.quantize_act(x, s1, s2)
    assert torch.equal(a, qconv.quantize_act(x, s1))
    assert torch.equal(b, qconv.quantize_act_reference(x, s2))
    assert b.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        qconv.quantize_act(x, s1, torch.tensor([0.5]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_abs_max_equals_amax_of_abs(dtype):
    gen = torch.Generator().manual_seed(2)
    x = cl((torch.randn((2, 16, 5, 7), generator=gen) * 3).to(dtype))
    assert torch.equal(qconv.abs_max(x), x.abs().amax().float())
    flat = x.permute(0, 2, 3, 1).view(-1)  # x's storage, in order
    flat[7] = float("-inf")
    assert qconv.abs_max(x).item() == float("inf")
    flat[9] = float("nan")
    assert bool(torch.isnan(qconv.abs_max(x)))
    zeros = torch.full((3, 5), -0.0, dtype=dtype)
    got = qconv.abs_max(zeros)
    assert got.item() == 0.0 and not bool(torch.signbit(got))
    assert got.dtype == torch.float32 and got.dim() == 0
    with pytest.raises(ValueError):
        qconv.abs_max(torch.zeros((0,)))
    with pytest.raises(TypeError):
        qconv.abs_max(torch.zeros((3,), dtype=torch.int32))


def test_ste_step_is_act_step_of_the_abs_max():
    gen = torch.Generator().manual_seed(3)
    x = cl(torch.randn((2, 16, 6, 6), generator=gen).to(torch.bfloat16))
    w = (torch.randn((8, 16, 1, 1), generator=gen) * 0.1).to(torch.bfloat16)
    seen = {}
    real = qconv.quantize_act

    def spy(t, step, *a):
        seen["step"] = step
        return real(t, step, *a)
    qconv.quantize_act = spy
    try:
        pq.ste_forward(x, w, 1)
    finally:
        qconv.quantize_act = real
    assert torch.equal(seen["step"], pq.act_step(x.abs().amax().float()))


# ----------------------------------------------------------- the int8 twin


TWINS = {"throughput": dict(tier="throughput"),
         "residual": dict(infer_dtype="int8", hourglass_inch=32,
                          stem_width=32)}


def twin_cfg(name):
    return apply_tier(Config(device="cpu", imsize=64, num_cls=2,
                             **TWINS[name]))


def unfuse(model):
    for m in model.modules():
        if isinstance(m, Residual):
            m.fuse_codes = False


@pytest.mark.parametrize("name", list(TWINS))
def test_fused_twin_bit_equal_to_unfused(name, monkeypatch):
    cfg = twin_cfg(name)
    fcfg = dataclasses.replace(cfg, infer_dtype="bf16")
    torch.manual_seed(0)
    model = build_model(fcfg)
    convert.load_into(model, bn_scaled(
        convert.state_dict_to_flax(model.state_dict()), 4))
    scales = pq.calibrate_scales(
        fcfg, model.state_dict(),
        pq.synthetic_calibration_batches(2, 64, raw=True),
        normalize="imagenet", device="cpu")
    predict = make_predict_fn(model, cfg, normalize="imagenet", device="cpu",
                              quant_scales=scales)
    twin = predict.model
    assert all(m.fuse_codes for m in twin.modules()
               if isinstance(m, Residual))
    calls = {"n": 0}
    real = qconv.quantize_act

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)
    monkeypatch.setattr(qconv, "quantize_act", counting)
    images = np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        logits = twin(x)
    fused_calls = calls["n"]
    dets = predict(images)
    unfuse(twin)
    calls["n"] = 0
    with torch.inference_mode():
        plain = twin(x)
    unfused_calls = calls["n"]
    assert torch.equal(logits, plain) and bool(torch.isfinite(logits).all())
    assert all(torch.equal(a, b) for a, b in zip(dets, predict(images)))
    assert fused_calls == 18 == chip_smoke.quant_walk(cfg)[0]
    assert unfused_calls == {"throughput": 70, "residual": 36}[name]


def test_fused_throughput_twin_matches_jax():
    """The throughput tier's fused twin on JAX's fold and scales against
    JAX's int8 twin, op by op (tests/test_torch_quant.py's rule)."""
    cfg = twin_cfg("throughput")
    jcfg = JaxConfig(epilogue="xla", block_fuse="xla", variant="ghost",
                     hourglass_inch=96, stem_width=96, imsize=64, num_cls=2)
    model = jax_build(jcfg)
    images = np.random.default_rng(0).normal(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    v = bn_scaled(jax.device_get(jax.jit(
        model.init, static_argnames=("train",))(
            jax.random.key(0), jnp.asarray(images), train=False)), 1)
    scales = jq.calibrate_scales(jcfg, v,
                                 jq.synthetic_calibration_batches(2, 64))
    folded = jax.device_get(jq.fold_batchnorm(v["params"], v["batch_stats"]))
    twin = build_model(cfg, fold_bn=True, quant_mode="int8")
    convert.load_into(twin, {"params": folded, "quant": scales})
    pq.requantize(twin)
    twin.eval()
    assert all(m.fuse_codes for m in twin.modules()
               if isinstance(m, Residual))
    want = np.asarray(jq.make_quant_model(jcfg, mode="int8").apply(
        {"params": folded, "quant": scales}, jnp.asarray(images),
        train=False))
    with torch.inference_mode():
        got = twin(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_count_of_fused_twin_holds_the_codes():
    """OpCount over a fused int8 forward on the CPU: the int8 conv rows'
    bytes are each call's input, weights, stored output and Cout
    channels of each code output; the quantizer's rows its input and its
    one or two outputs; no quantizer call reads a conv's output."""
    from real_time_helmet_detection_tpu_torch.obs import roofline
    cfg = twin_cfg("throughput")
    twin = build_model(cfg, fold_bn=True, quant_mode="int8").eval()
    x = torch.zeros((1, 64, 64, 3))
    with torch.inference_mode(), roofline.OpCount(device="cpu") as count:
        twin(x)
    rows = {r["name"]: r for r in count.table()}
    dense, dw = chip_smoke.qconv_sites(cfg)
    quant, dual = chip_smoke.quant_walk(cfg)
    assert rows["qconv_dense"]["calls"] == dense
    assert rows["qconv_dw"]["calls"] == dw
    assert rows["quantize_act"]["calls"] == quant == 18 and dual == 1
    calls = [c for c in count.kernel_calls if c[0] == "quantize_act"]
    # f32 twin: 4 bytes in and 1 out an element; the first block's input
    # (64 channels at 32^2) also 1 more, its codes at the projection's
    # step
    assert calls[0][1] == 64 * 32 * 32
    assert sum(c[3] for c in calls) == sum(
        c[1] * (c[2] + 1) for c in calls) + calls[0][1]
    total = rows["qconv_dense"]["bytes"] + rows["qconv_dw"]["bytes"]
    unfuse(twin)
    with torch.inference_mode(), roofline.OpCount(device="cpu") as plain:
        twin(x)
    prow = {r["name"]: r for r in plain.table()}
    assert prow["quantize_act"]["calls"] == 70
    # the same convs: FLOPs counted from their inputs, whether or not a
    # conv stores a float output
    for name in ("qconv_dense", "qconv_dw"):
        assert rows[name]["flops"] == prow[name]["flops"] > 0
    # each fused site trades a float store for one byte a code, and the
    # quantizer's read of it is gone
    assert total < prow["qconv_dense"]["bytes"] + prow["qconv_dw"]["bytes"]
    assert rows["quantize_act"]["bytes"] < prow["quantize_act"]["bytes"]


def test_fused_twin_compiles_with_aotinductor(tmp_path):
    """The throughput tier's fused twin at 64^2 (its innermost maps are
    1x1, where a channels-last buffer's layout is ambiguous) through
    `torch.export` and AOTInductor on the CPU: the `*_codes` ops' writes
    land where the next ops read them, the package's logits bit-equal to
    the eager twin's."""
    cfg = twin_cfg("throughput")
    twin = build_model(cfg, fold_bn=True, quant_mode="int8").eval()
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for p in twin.parameters():
            p.normal_(0, 0.1, generator=gen)
        for m in pq.quant_modules(twin).values():
            m.act_scale.fill_(2.0)
    pq.requantize(twin)
    x = torch.randn((1, 64, 64, 3), generator=gen)
    with torch.no_grad():
        ep = torch.export.export(twin, (x,))
        calls = {str(n.target).split(".")[1] for n in ep.graph.nodes
                 if str(n.target).startswith("helmet.")}
        assert {"qconv_dense_codes", "qconv_dw_codes",
                "quantize_act2"} <= calls
        path = torch._inductor.aoti_compile_and_package(
            ep, package_path=str(tmp_path / "twin.pt2"))
        got = torch._inductor.aoti_load_package(path)(x)
        want = twin(x)
    got = got[0] if isinstance(got, (list, tuple)) else got
    assert torch.equal(got, want)
