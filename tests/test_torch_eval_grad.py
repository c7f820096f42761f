"""Gradients through the port's eval-mode BatchNorm against the JAX
package, on the CPU.

In eval mode every BN'd conv ends in `ops.epilogue.bn_act_eval` or, at the
end of a Residual block, `ops.residual.bn_add_act_eval`: the forward
kernel over the folded running statistics and a one-pass backward
(`bn_eval_bwd` / `bn_add_eval_bwd`, the ports of ref
ops/pallas/epilogue.py:144 `_bwd_kernel` and residual.py:97
`_bwd_add_kernel`), which run their plain versions for CPU tensors. The
JAX side runs `fused_bn_act` / `fused_bn_add_act` with the Pallas kernels
in interpret mode and with the jnp twins. Same seeded numpy inputs,
(2, 16, 8, 8) (NHWC (2, 8, 8, 16) on the JAX side), every activation,
f32 and bf16.

* the backward wrappers' dx (and ds) and the channel sums of d(scale),
  d(bias) against `jax.vjp` with the same cotangent;
* forward and autograd gradients of sum(out^2) w.r.t. x, scale, bias
  (and skip) through `bn_act_eval` / `bn_add_act_eval` against
  `jax.grad`;
  both with the tolerances of tests/test_epilogue.py:61-80: forward
  1e-5 (bf16 3e-2), gradients 1e-4 (bf16 1.5e-1);
* the whole model in eval mode: the fused loss's gradient w.r.t. every
  parameter against `jax.grad` of `model.apply(train=False)` under
  `epilogue="fused", block_fuse="fused"` and the JAX fused loss, on the
  same weights by the bridge;
* launch sites, layout conversion and refused operands.

Observed maxima on this CPU are written beside each pin.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu.ops.pallas import (fused_detection_loss
                                                       as jax_fused_loss)
from real_time_helmet_detection_tpu.ops.pallas.epilogue import fused_bn_act
from real_time_helmet_detection_tpu.ops.pallas.residual import \
    fused_bn_add_act
from real_time_helmet_detection_tpu.train import init_variables
from real_time_helmet_detection_tpu_torch import convert
from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.data.synthetic import \
    synthetic_target_batch
from real_time_helmet_detection_tpu_torch.models.hourglass import build_model
from real_time_helmet_detection_tpu_torch.ops import epilogue, residual
from real_time_helmet_detection_tpu_torch.ops.loss import fused_detection_loss
from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

ACTS = ("ReLU", "Mish", "Linear")
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 8, 8, 16)) * 2).astype(np.float32)
    skip = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    g = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    scale = (rng.standard_normal(16) * 0.5 + 1).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    return x, scale, bias, skip, g


def to_port(a: np.ndarray, dtype, grad=False) -> torch.Tensor:
    """NHWC numpy -> NCHW channels-last tensor of `dtype`."""
    t = torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2).detach()
    return t.requires_grad_(grad)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def jax_fn(skip, act, interpret):
    if skip:
        return lambda x, a, b, s: fused_bn_add_act(
            x, a, b, s, activation=act, interpret=interpret)
    return lambda x, a, b: fused_bn_act(x, a, b, activation=act,
                                        interpret=interpret)


def tolerances(tag):
    """(forward, gradient) tolerance, tests/test_epilogue.py:61-80."""
    return (1e-5, 1e-4) if tag == "f32" else (3e-2, 1.5e-1)


@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("skip", [False, True], ids=["epilogue", "tail"])
def test_eval_bwd_matches_jax_vjp(skip, act, tag):
    """dx (and ds) and the summed partials of d(scale), d(bias) from the
    backward wrapper against `jax.vjp` of the JAX eval function with the
    same cotangent. Observed max abs: f32 dx/ds 6.2e-6, summed partials
    2.5e-5; bf16 dx/ds 6.1e-5, summed partials 3.4e-5."""
    x, a, b, s, g = inputs(0)
    tdt, jdt = DTYPES[tag]
    _, gtol = tolerances(tag)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    if skip:
        dx, ds, da, db = residual.bn_add_eval_bwd(
            to_port(x, tdt), at, bt, to_port(s, tdt), to_port(g, tdt), act)
        got = [nhwc(dx), da.sum(0).numpy(), db.sum(0).numpy(), nhwc(ds)]
    else:
        dx, da, db = epilogue.bn_eval_bwd(to_port(x, tdt), at, bt,
                                          to_port(g, tdt), act)
        got = [nhwc(dx), da.sum(0).numpy(), db.sum(0).numpy()]
    assert dx.dtype == tdt and dx.is_contiguous(
        memory_format=torch.channels_last)
    args = [jnp.asarray(x, jdt), jnp.asarray(a), jnp.asarray(b)]
    if skip:
        args.append(jnp.asarray(s, jdt))
    for interpret in (True, None):  # Pallas interpret, jnp twin
        _, vjp = jax.vjp(jax_fn(skip, act, interpret), *args)
        want = [np.asarray(w, np.float32)
                for w in vjp(jnp.asarray(g, jdt))]
        for name, gv, wv in zip(("x", "scale", "bias", "skip"), got, want):
            np.testing.assert_allclose(gv, wv, rtol=gtol, atol=gtol,
                                       err_msg="d%s" % name)


@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("skip", [False, True], ids=["epilogue", "tail"])
def test_eval_bn_autograd_matches_jax_grad(skip, act, tag):
    """Forward and the gradients of sum(out^2) through the differentiable
    eval BN (`BNEval`) against `jax.grad` through the JAX custom_vjp.
    Observed: forward max abs 1.9e-6 (f32), 3.8e-6 (bf16); gradients
    max |err| / (1 + |value|) 9.3e-6 (f32), 1.5e-5 (bf16)."""
    x, a, b, s, _ = inputs(1)
    tdt, jdt = DTYPES[tag]
    ftol, gtol = tolerances(tag)
    leaves = [to_port(x, tdt, True), torch.from_numpy(a).requires_grad_(),
              torch.from_numpy(b).requires_grad_()]
    if skip:
        leaves.append(to_port(s, tdt, True))
        out = residual.bn_add_act_eval(*leaves[:3], leaves[3], act)
    else:
        out = epilogue.bn_act_eval(*leaves, act)
    (out.float() ** 2).sum().backward()
    got = [nhwc(leaves[0].grad), leaves[1].grad.numpy(),
           leaves[2].grad.numpy()] + ([nhwc(leaves[3].grad)] if skip else [])
    args = [jnp.asarray(x, jdt), jnp.asarray(a), jnp.asarray(b)]
    if skip:
        args.append(jnp.asarray(s, jdt))
    for interpret in (True, None):
        fn = jax_fn(skip, act, interpret)
        np.testing.assert_allclose(nhwc(out), np.asarray(fn(*args),
                                                         np.float32),
                                   rtol=ftol, atol=ftol)
        want = jax.grad(lambda *ar: jnp.sum(fn(*ar).astype(jnp.float32)
                                            ** 2),
                        argnums=tuple(range(len(args))))(*args)
        for name, gv, wv in zip(("x", "scale", "bias", "skip"), got, want):
            np.testing.assert_allclose(gv, np.asarray(wv, np.float32),
                                       rtol=gtol, atol=gtol,
                                       err_msg="grad %s" % name)


# ------------------------------------------------------------ whole model


def rel_l2(got: dict, want: dict) -> float:
    num = sum(float(np.sum((got[n].astype(np.float64) - want[n]) ** 2))
              for n in want)
    den = sum(float(np.sum(np.asarray(want[n], np.float64) ** 2))
              for n in want)
    return math.sqrt(num / den)


# architectures beside the flagship's stacks: the ghost variant with a
# PReLU slope at every unfused site, and the depthwise variant with Mish
# (its tails fused)
EVAL_GRAD_CASES = {
    "ghost-prelu": dict(variant="ghost", activation="PReLU"),
    "depthwise-mish": dict(variant="depthwise", activation="Mish"),
}


@pytest.mark.parametrize("ns", [1, 2] + list(EVAL_GRAD_CASES))
def test_eval_model_gradient_matches_jax(ns):
    """`model.eval()`, the fused loss, `backward()`: every parameter of
    the port gets a non-zero gradient (the PReLU slopes among them), and
    the gradient of all of them, taken as one vector, is within rel L2
    1e-4 of `jax.grad` through `model.apply(train=False)` (epilogue and
    block tail fused where JAX fuses them, the JAX fused loss in
    interpret mode) on the same bridged weights and a random BN state
    (observed 1 stack 1.4e-7, 2 stacks 2.2e-7, ghost-prelu 3.2e-7,
    depthwise-mish 2.8e-7: no batch statistics, so nothing amplifies the
    summation order); the loss rtol 1e-5 (observed 1.3e-7)."""
    imsize = 64
    arch = dict(num_stack=ns) if ns in (1, 2) else EVAL_GRAD_CASES[ns]
    seed = ns if ns in (1, 2) else 3
    jcfg = JaxConfig(hourglass_inch=16, imsize=imsize,
                     batch_size=2, epilogue="fused", block_fuse="fused",
                     loss_kernel="fused", **arch)
    jmodel = jax_build(jcfg)
    params, stats = jax.device_get(init_variables(
        jmodel, jax.random.key(seed), imsize))
    rng = np.random.default_rng(seed)
    flat = convert.flatten_tree({"params": params, "batch_stats": stats})
    for k, v in flat.items():  # a random BN state: the fold matters
        if k.startswith("batch_stats") and k.endswith("mean"):
            flat[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k.startswith("batch_stats"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("scale"):
            flat[k] = rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
    variables = convert.unflatten_tree(flat)
    arrs = synthetic_target_batch(2, imsize, seed=seed)

    def jtotal(p):
        out = jmodel.apply({"params": p,
                            "batch_stats": variables["batch_stats"]},
                           jnp.asarray(arrs[0]), train=False)
        return jax_fused_loss(out, *map(jnp.asarray, arrs[1:]),
                              interpret=True)["total"]

    jl, jgrads = jax.jit(jax.value_and_grad(jtotal))(variables["params"])
    want = {n: t.numpy() for n, t in convert.flax_to_state_dict(
        {"params": jax.device_get(jgrads)}).items()}
    model = build_model(Config(device="cpu", hourglass_inch=16,
                               batch_size=2, **arch))
    convert.load_into(model, variables)
    model.eval()
    total = fused_detection_loss(model(torch.from_numpy(arrs[0])),
                                 *map(torch.from_numpy, arrs[1:]))["total"]
    total.backward()
    got = {n: p.grad.numpy() for n, p in model.named_parameters()
           if p.grad is not None}
    assert sorted(got) == sorted(want) == sorted(
        n for n, _ in model.named_parameters())
    assert all(np.abs(g).max() > 0 for g in got.values())
    if ns == "ghost-prelu":
        assert sum(n.endswith("negative_slope") for n in got) == 1 + 3 * 13
    np.testing.assert_allclose(total.item(), float(jl), rtol=1e-5)
    assert rel_l2(got, want) <= 1e-4, rel_l2(got, want)


@pytest.mark.parametrize("name", ["edge-arch", "quality-arch",
                                  "depthwise-128", "options"])
def test_variant_eval_backward_launch_sites(monkeypatch, name):
    """One eval-mode loss + backward of each of chip_smoke.py's
    configurations at 64^2 runs the eval backward at every site of
    tests/test_torch_predict.py's VARIANT_SITES (the counts its phase
    variants_train holds for the eval-mode gradient); no launch counter
    moves on the CPU."""
    from test_torch_predict import VARIANT_SITES, chip_smoke
    calls = {}

    def counting(mod, attr):
        real = getattr(mod, attr)
        calls[attr] = 0

        def wrapper(*args, **kw):
            calls[attr] += 1
            return real(*args, **kw)
        monkeypatch.setattr(mod, attr, wrapper)

    for mod, attr in ((epilogue, "bn_act"), (epilogue, "bn_eval_bwd"),
                      (residual, "bn_add_act"),
                      (residual, "bn_add_eval_bwd")):
        counting(mod, attr)
    cfg = Config(device="cpu", batch_size=1, imsize=64,
                 **chip_smoke.VARIANT_CONFIGS[name])
    model = build_model(cfg).eval()
    before = (epilogue.eval_bwd_launches, residual.eval_bwd_launches)
    arrs = [torch.from_numpy(a) for a in synthetic_target_batch(1, 64)]
    fused_detection_loss(model(arrs[0]), *arrs[1:])["total"].backward()
    epi, tail = VARIANT_SITES[name]
    assert calls == {"bn_act": epi, "bn_eval_bwd": epi, "bn_add_act": tail,
                     "bn_add_eval_bwd": tail}
    want = chip_smoke.expected_launches(cfg, "eval_grad", torch.float32)
    assert (want["bn_eval_bwd"], want["bn_add_eval_bwd"]) == (epi, tail)
    assert all(p.grad is not None for p in model.parameters())
    assert (epilogue.eval_bwd_launches, residual.eval_bwd_launches) == before


def test_flagship_eval_backward_launch_sites(monkeypatch):
    """One eval-mode loss + backward at the flagship width runs the eval
    backward at every BN site: 20 epilogue and 17 residual-tail backward
    passes beside 20 + 17 forwards; predict (inference mode) runs none.
    On the CPU no launch counter moves."""
    calls = {}

    def counting(mod, name):
        real = getattr(mod, name)
        calls[name] = 0

        def wrapper(*args, **kw):
            calls[name] += 1
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    for mod, name in ((epilogue, "bn_act"), (epilogue, "bn_eval_bwd"),
                      (residual, "bn_add_act"),
                      (residual, "bn_add_eval_bwd")):
        counting(mod, name)
    cfg = Config(device="cpu", batch_size=1, imsize=64)  # 128 ch, 1 stack
    model = build_model(cfg).eval()
    before = (epilogue.eval_bwd_launches, residual.eval_bwd_launches)
    arrs = [torch.from_numpy(a) for a in synthetic_target_batch(1, 64)]
    fused_detection_loss(model(arrs[0]), *arrs[1:])["total"].backward()
    assert calls == {"bn_act": 20, "bn_eval_bwd": 20, "bn_add_act": 17,
                     "bn_add_eval_bwd": 17}
    images = np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3),
                                               dtype=np.uint8)
    make_predict_fn(model, cfg, normalize="imagenet", device="cpu")(images)
    assert calls == {"bn_act": 40, "bn_eval_bwd": 20, "bn_add_act": 34,
                     "bn_add_eval_bwd": 17}
    assert (epilogue.eval_bwd_launches, residual.eval_bwd_launches) == before


def test_eval_grad_in_another_layout_is_converted_and_counted():
    """A gradient that reaches the eval backward in contiguous NCHW is
    copied to channels-last and counted; the result equals the
    channels-last gradient's."""
    x, a, b, _, _ = inputs(2)
    grads = []
    for fmt in (torch.channels_last, torch.contiguous_format):
        xt = to_port(x, torch.float32, True)
        out = epilogue.bn_act_eval(xt, torch.from_numpy(a),
                                   torch.from_numpy(b), "Mish")
        g = torch.ones_like(out).contiguous(memory_format=fmt) * 0.5
        before = epilogue.grad_conversions
        out.backward(g)
        assert epilogue.grad_conversions - before == (
            fmt is torch.contiguous_format)
        grads.append(xt.grad)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("bad", ["layout", "activation", "scale"])
def test_eval_wrappers_refuse_bad_operands(bad):
    x, a, b, s, g = inputs(3)
    xt, gt, st = (to_port(v, torch.float32) for v in (x, g, s))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    act = "ReLU"
    if bad == "layout":
        xt = xt.contiguous()
    elif bad == "activation":
        act = "CELU"
    else:
        at = at[:8]
    for call in (lambda: epilogue.bn_act_eval(xt, at, bt, act),
                 lambda: residual.bn_add_act_eval(xt, at, bt, st, act),
                 lambda: epilogue.bn_eval_bwd(xt, at, bt, gt, act),
                 lambda: residual.bn_add_eval_bwd(xt, at, bt, st, gt, act)):
        with pytest.raises((ValueError, NotImplementedError)):
            call()
